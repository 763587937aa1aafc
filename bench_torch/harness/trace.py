"""Spans from the benchmark's own files, the profiled window, and the
reduction of its trace to what the per-layer readers take.

A span is a ``torch.profiler.record_function`` named ``bench.<layer>``,
opened by a driver around a call into a layer of the program.  The window
runs under ``torch.profiler`` (CPU and CUDA activity); its Chrome trace is
reduced to:

- ``busy_s``: the union of device activity (kernels, copies, sets) inside
  the window, and ``window_s``, the window span's length;
- ``span_device_s``: per span name, the device seconds of the activity
  launched while the host was inside a span of that name (a launch is tied
  to its activity by the trace's correlation id), so the time is
  attributed by where the work comes from, not by a list of kernel names;
  and per span name ``<name>.backward``, that launched by the autograd
  nodes whose forward op ran inside such a span (tied by the ops'
  sequence numbers), outside any span of the name (a forward recomputed in
  the backward counts under the span it opens);
- ``device_ops``: device seconds by kernel group (``kernel_group``), and
  ``idle_gaps``: the longest gaps with no device activity, each labelled by
  the innermost span the host was in when it began; ``other``: the largest
  kernels no group names.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from functools import lru_cache
from typing import Dict, List, Tuple

import torch

from bench_torch.harness.registry import REPO

PREFIX = "bench."
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NODE = "autograd::engine::evaluate_function: "
BACKWARD = ".backward"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Opens ``bench.<name>`` spans while a traced window runs, else nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._open: List[torch.profiler.record_function] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield

    def enter(self, name: str) -> None:
        """Open a span that :meth:`exit` closes (for module hooks)."""
        if self.enabled:
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self._open.append(rf)

    def exit(self) -> None:
        if self.enabled and self._open:
            self._open.pop().__exit__(None, None, None)


def profiled(fn):
    """``(fn(), events)``: ``fn`` under ``torch.profiler`` inside a
    ``bench.window`` span, with the trace's events."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, events


@lru_cache(maxsize=1)
def port_kernel_names() -> Tuple[str, ...]:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")
    for src in sorted((REPO / "blade_torch" / "csrc").glob("*.cu*")):
        names.update(pat.findall(src.read_text()))
    return tuple(sorted(names))


# Library kernels by category, first match wins (lower-case substrings of
# the kernel's name).
_LIBRARY_GROUPS = (
    ("conv (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn")),
    ("gemm (cuBLAS/CUTLASS)", ("gemm", "nvjet", "cutlass", "cublas", "xmma", "sm90_")),
    ("norm", ("layer_norm", "layernorm", "group_norm", "groupnorm", "rms_norm", "batch_norm",
              "moments", "fusedparams", "welford")),
    ("softmax", ("softmax",)),
    ("sort / topk", ("sort", "topk", "radix")),
    ("upsample / repeat", ("upsample", "interp", "repeat")),
    ("copy / cat / index", ("memcpy", "memset", "copy", "catarray", "index", "gather",
                            "scatter")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


@lru_cache(maxsize=4096)
def kernel_group(name: str) -> str:
    """The group of a device activity in ``breakdown``: a port kernel by its
    ``__global__`` name, a library kernel by category."""
    ident = re.sub(r"^void\s+", "", name)
    ident = re.split(r"[<(]", ident, maxsplit=1)[0].strip().split("::")[-1]
    if ident in port_kernel_names():
        return ident
    low = name.lower()
    for group, keys in _LIBRARY_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _SpanIndex:
    """Spans of each name, sorted, for 'which spans hold time t'."""

    def __init__(self, spans: List[Tuple[str, float, float]]):
        self.by_name: Dict[str, Tuple[List[float], List[float]]] = {}
        for name, a, b in sorted(spans, key=lambda s: s[1]):
            starts, ends = self.by_name.setdefault(name, ([], []))
            starts.append(a)
            ends.append(b)

    def holds(self, name: str, t: float) -> bool:
        starts, ends = self.by_name[name]
        i = bisect.bisect_right(starts, t) - 1  # spans of one name never overlap
        return i >= 0 and t <= ends[i]

    def innermost(self, t: float) -> str:
        best, best_len = None, float("inf")
        for name, (starts, ends) in self.by_name.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and starts[i] <= t <= ends[i] and ends[i] - starts[i] < best_len:
                best, best_len = name, ends[i] - starts[i]
        return best[len(PREFIX):] if best else "outside every span"


def reduce_trace(events: List[dict], top: int = 10) -> dict:
    """The window's device activity, attributed to spans (see module doc)."""
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("tid"))
             for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and str(e.get("name", "")).startswith(PREFIX)]
    windows = [s for s in spans if s[0] == WINDOW]
    if not windows:
        raise ValueError("the trace holds no window span")
    w0, w1 = windows[0][1], windows[0][2]
    inner = [s[:3] for s in spans if s[0] != WINDOW]
    index = _SpanIndex(inner)
    # Sequence numbers of the ops the forward (the window's thread) ran
    # inside each span; the autograd nodes evaluated later carry them.
    main = windows[0][3]
    launch, created, nodes = {}, {name: set() for name in index.by_name}, []
    for e in events:
        args = e.get("args", {})
        if e.get("cat") in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = float(e["ts"])
        elif e.get("cat") == "cpu_op" and "Sequence number" in args:
            t = float(e["ts"])
            if e["name"].startswith(NODE):
                nodes.append((args["Sequence number"], t, t + float(e.get("dur", 0))))
            elif e.get("tid") == main:
                for name in index.by_name:
                    if index.holds(name, t):
                        created[name].add(args["Sequence number"])
    backward = _SpanIndex([(name + BACKWARD, a, b) for name in index.by_name
                           for s, a, b in nodes if s in created[name]])
    acts = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]

    busy, groups, other = [], {}, {}
    span_device = {name: 0.0 for name in list(index.by_name) + list(backward.by_name)}
    for e in acts:
        a, dur = float(e["ts"]), float(e.get("dur", 0))
        lo, hi = max(a, w0), min(a + dur, w1)
        if hi > lo:
            busy.append((lo, hi))
        g = kernel_group(e["name"])
        groups[g] = groups.get(g, 0.0) + dur
        if g == "other":
            other[e["name"]] = other.get(e["name"], 0.0) + dur
        t_launch = launch.get(e.get("args", {}).get("correlation"))
        if t_launch is not None:
            for name in index.by_name:
                if index.holds(name, t_launch):
                    span_device[name] += dur
                elif name + BACKWARD in backward.by_name and \
                        backward.holds(name + BACKWARD, t_launch):
                    span_device[name + BACKWARD] += dur
    merged = _merge(busy)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in merged) * 1e-6,
        "span_device_s": {n[len(PREFIX):]: s * 1e-6 for n, s in span_device.items()},
        "device_ops": [[g, s * 1e-6] for g, s in
                       sorted(groups.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[index.innermost(a), (b - a) * 1e-6] for a, b in gaps[:top]],
        "other": [[n, t * 1e-6] for n, t in sorted(other.items(), key=lambda kv: -kv[1])[:5]],
    }
