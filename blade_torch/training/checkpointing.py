"""Checkpointing for TDM training: save, rotate, resume.

Counterpart of ``blade/training/checkpointing.py`` (orbax there,
``torch.save`` here) with the same surface: ``save``, ``latest_step``,
``restore(template, step)`` and ``all_steps``, with ``max_to_keep``
rotation.  A checkpoint is ``<directory>/<step>/state.pt`` holding the
step, both adapters and both optimizer states, so a resume is exact; the
frozen base is rebuilt by the caller (it is the template's).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import List, Optional

import torch

from blade_torch.training.tdm import TDMState

__all__ = ["CheckpointManager"]

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, _FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TDMState) -> None:
        """Write ``state`` as step ``step`` (through a temporary directory
        and a rename, so a cut save leaves no half checkpoint), then drop
        the oldest checkpoints beyond ``max_to_keep``."""
        payload = {"step": state.step, "lora_g": state.lora_g, "lora_f": state.lora_f,
                   "opt_g": state.opt_g, "opt_f": state.opt_f}
        final = os.path.join(self.directory, str(int(step)))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, template: TDMState, step: Optional[int] = None) -> TDMState:
        """``template`` with the step, adapters and optimizer states of
        checkpoint ``step`` (default: the latest), on the template's device."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        device = next(iter(template.base.values())).device
        payload = torch.load(os.path.join(self.directory, str(int(step)), _FILE),
                             map_location=device, weights_only=True)
        return dataclasses.replace(template, step=int(payload["step"]),
                                   lora_g=payload["lora_g"], lora_f=payload["lora_f"],
                                   opt_g=payload["opt_g"], opt_f=payload["opt_f"])
