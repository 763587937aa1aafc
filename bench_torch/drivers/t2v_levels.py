"""Text to video on ASA's per-level multilevel lane: ``drivers/t2v.py``'s
clips, with two changes that a 14 B model at 720p asks for.

- Set-up warms with a one-step clip.  It launches every kernel and builds
  every shape of the window's clips (each step runs the same DiT forward,
  then the decode runs) in about a fifth of a whole clip's time, so that a
  run with its reference check stays well inside its time.
- A traced window keeps each ASA call's int level mask as int8 (the levels
  0, 1, 2, 4, 8; ``[1, 40, 591, 591]`` is 14 MB against int32's 56 MB, 320
  a clip), and drops them once ``records`` has read them, before the
  reference check.

Traffic keys are ``drivers/t2v.py``'s.
"""

from __future__ import annotations

import torch

from bench_torch.drivers import t2v


class Driver(t2v.Driver):
    def _wire_asa(self):
        dit, spans = self.pipe.dit, self.spans
        fn = dit.attention_fn

        def collecting(q, k, v, **kw):
            with spans("asa"):
                out, mask = fn(q, k, v, collect_mask=True, **kw)
            if torch.is_tensor(mask) and mask.dtype != torch.bool:  # an int level mask
                mask = mask.to(torch.int8)
            self.asa.append((mask, q.shape[2], k.shape[2], q.shape[3]))
            return out

        dit.attention_fn = collecting

    def warm(self):
        steps, self.steps = self.steps, 1
        try:
            super().warm()
        finally:
            self.steps = steps

    def check(self, check_steps, control=False):
        self.asa = []
        return super().check(check_steps, control=control)
