"""Spans and counters of the port, on the profiler's clock.

A span is ``torch.profiler.record_function("blade." + name)``.  Under
``torch.profiler`` it shares a clock with the device activity the profiler
records, so a trace ties each kernel to the innermost span the host was in
when it launched it.  Spans nest by time on their own thread; those of one
clip or one training step lie inside its ``blade.sample`` or
``blade.tdm.step`` span, which serves as the request's identifier.

Counters are kept in memory and read once, after the work, by
:func:`counters`.  A device value is kept as a tensor and summed there, so
counting never waits for the device; nothing is updated in place (the
sampler runs under ``inference_mode``).

Tracing is on while a ``torch.profiler`` records, and off otherwise.  Off,
:func:`span` returns one shared ``nullcontext`` and :func:`count` returns at
once: nothing of ``torch.profiler`` runs and nothing is allocated or kept.

Spans, by layer (``blade.`` omitted):

- sampler: ``sample`` (``T2VPipeline.sample_latents``), ``sample.step``
  (one sampler step), ``sample.update`` (``unipc_step`` / ``dpm_step``);
- DiT: ``dit`` (a model forward), ``dit.embed`` (patchify, time and text
  embedding, RoPE tables, token permute), ``dit.block`` holding
  ``dit.modulate`` (AdaLN norms, modulation, gated residuals; in Wan's
  block also the cross-attention's LayerNorm and residual), ``dit.qkv``
  (projections, q/k norm and RoPE), ``dit.self_attn`` (``attention_fn`` and
  the output projection), ``dit.cross_attn`` (Wan) holding
  ``dit.cross_attn.image`` (Wan2.1-I2V's image branch: its K/V projections,
  norm and flash call), ``dit.ffn``; ``dit.head``; ``dit.image_embed``
  (Wan2.1-I2V's f32 image embedder, once a forward);
- ASA: ``asa`` (the model's ``attention_fn``) holding ``asa.predict``
  (block scores), ``asa.select`` (the energy mask or the level lists),
  ``asa.sparse`` (the block-sparse or multilevel kernel with its packing;
  on the per-level multilevel lane it holds ``asa.levels``, the pyramid
  pack and the three pooled levels, and ``asa.level_merge``, the four-way
  LSE merge; on the level carry ``asa.level_lists``, the four lists built
  from the int level mask), ``asa.pooled`` (the pooled K/V and its dense
  call), ``asa.merge`` (LSE merge and cast);
- VAE: ``decode`` (``decode_latents``), ``decode.tile`` (a spatial tile),
  ``decode.chunk`` (a temporal chunk); ``encode`` (``encode_image``: an
  image-to-video family's conditioning) and ``encode.chunk`` (a temporal
  chunk of the streaming encode);
- trainer: ``tdm.step`` (``train_step``), ``tdm.rollout``, ``tdm.merge``
  (a LoRA merge), ``tdm.fake`` and ``tdm.generator`` (the two updates),
  ``tdm.backward``, ``tdm.adam``; ``sync`` (a host readback of a device
  value, :func:`readback`).

Counters: ``asa.calls``, ``asa.blocks_selected``, ``asa.blocks_total``
(level-1 full-resolution key blocks of each mask a forward selects and could
select), ``asa.recomputed_calls`` (ASA calls of blocks recomputed in a
backward, counted there alone), ``dit.qk_norm_rope.calls`` (CogVideoX's
q/k LayerNorm, RoPE and head split, one a joint attention) and
``dit.qk_norm_rope.recomputed_calls`` (those of blocks recomputed in a
backward, counted there alone), ``dit.cross_attn.calls`` (Wan's text
cross-attention, one a block) and ``dit.cross_attn.recomputed_calls`` (those
of blocks recomputed in a backward, counted there alone),
``dit.cross_attn.image_calls`` (Wan2.1-I2V's image branch, one a block; left
out where recomputed), ``dit.modulate.fused_calls`` and
``dit.modulate.autograd_calls`` (a Wan block forward whose glue ran as the
row kernels, where autograd records nothing, or as their expression; left
out where recomputed), ``host_syncs``,
``asa.per_level_calls`` (calls of the per-level multilevel lane, those of
blocks recomputed in a backward left out), ``asa.level_carry_calls`` (calls
of the level carry, an int level mask past the fused lane's rule run as
one carry on the card; left out where recomputed) and, from :func:`timed`
spans, ``sample.seconds``, ``decode.seconds``, ``encode.seconds``,
``asa.levels.seconds`` and
``asa.level_merge.seconds`` (the per-level lane's two spans, left out where
recomputed).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

__all__ = ["active", "span", "timed", "count", "readback", "recompute",
           "recomputing", "counters", "reset", "profile_to"]

PREFIX = "blade."
_OFF = contextlib.nullcontext()
_counts: Dict[str, List] = {}
_recompute_depth = 0


# Whether spans open and counters count now: while a profiler records.
active = torch.autograd._profiler_enabled


def span(name: str):
    """``blade.<name>`` around a ``with`` block while tracing, else the
    shared ``nullcontext``."""
    if not active():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


class _Elapsed:
    """Seconds from a span's start to the later of its end and the end of
    the device work launched inside it (the current CUDA stream's)."""

    def __init__(self, device_events: bool):
        self.t0, self.t1 = time.perf_counter(), None
        self.events = None
        if device_events:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()

    def close(self) -> None:
        if self.events is not None:
            self.events[1].record()
        self.t1 = time.perf_counter()

    def __float__(self) -> float:
        host = self.t1 - self.t0
        if self.events is None:
            return host
        self.events[1].synchronize()
        return max(host, self.events[0].elapsed_time(self.events[1]) * 1e-3)


@contextlib.contextmanager
def _timed(name: str):
    elapsed = _Elapsed(torch.cuda.is_available() and torch.cuda.is_initialized())
    with torch.profiler.record_function(PREFIX + name):
        try:
            yield
        finally:
            elapsed.close()
    _counts.setdefault(name + ".seconds", []).append(elapsed)


def timed(name: str):
    """:func:`span`, whose seconds also count as ``<name>.seconds``: from
    its start to the later of its end and the device's completion of the
    work launched inside it (CUDA events; exact when the device is idle at
    the start, as after a ``synchronize``)."""
    if not active():
        return _OFF
    return _timed(name)


def count(name: str, value=1) -> None:
    """Adds ``value`` (a number or a 0-d tensor) to counter ``name``."""
    if active():
        _counts.setdefault(name, []).append(value)


def readback(t: torch.Tensor) -> float:
    """``float(t)``: a host readback, inside a ``sync`` span that counts
    ``host_syncs`` while tracing."""
    if not active():
        return float(t)
    with torch.profiler.record_function(PREFIX + "sync"):
        _counts.setdefault("host_syncs", []).append(1)
        return float(t)


@contextlib.contextmanager
def _recompute():
    global _recompute_depth
    _recompute_depth += 1
    try:
        yield
    finally:
        _recompute_depth -= 1


def recompute(on: bool):
    """With ``on``, marks the ``with`` block as work recomputed in a backward
    (``checkpoint_block``) while tracing, so counters of the forward leave
    it out."""
    if not (on and active()):
        return _OFF
    return _recompute()


def recomputing() -> bool:
    return _recompute_depth > 0


def counters() -> Dict[str, float]:
    """Each counter's total (device values read back here, once)."""
    return {name: sum(float(v) for v in vals) for name, vals in _counts.items()}


def reset() -> None:
    _counts.clear()


@contextlib.contextmanager
def profile_to(path: Optional[str]):
    """Runs the ``with`` block under ``torch.profiler`` (CPU activity, and
    CUDA where a card is present), so tracing is on, and writes its Chrome
    trace to ``path``; with no ``path``, just runs it."""
    if path is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
