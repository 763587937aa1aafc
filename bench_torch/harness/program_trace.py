"""A profiled window reduced by the program's own spans (``blade.*``,
``blade_torch.utils.tracing``), beside ``trace.reduce_trace``, which reduces
the same events by the benchmark's ``bench.*`` spans and reads no
``blade.*`` span.

It takes ``trace.py``'s pieces: ``_SpanIndex`` (which spans hold a time),
``kernel_group`` and ``port_kernel_names`` (a port kernel by its
``__global__`` name), ``_merge``, and the same two ties: a device activity
to its launch by the trace's correlation id, an autograd node to the
forward op that made it by the ops' sequence numbers.  It gives:

- ``window_s``, ``busy_s``: as ``reduce_trace``'s (the ``bench.window``
  span, or, without one, the first program span's start to the last end of
  a program span or a device activity);
- ``span_device_s``: per program span name, the device seconds launched
  while the host was inside a span of that name, and ``asa.backward``: those
  launched by the autograd nodes whose forward op ran inside ``blade.asa``
  on the window's thread, outside every ``blade.asa`` span;
- ``complete_s``, ``spans``: per name of ``COMPLETE``, the seconds from each
  span's start to the later of its end and the end of the last device
  activity launched inside it, summed, and the number of such spans;
- ``program_idle_gaps``: the longest gaps with no device activity, each
  labelled by the innermost program span the host was in when it began,
  and ``idle_s_by_span``: every gap's seconds summed by that label;
- ``asa_glue_share``: the share, in %, of the device time of ``blade.asa``
  and ``asa.backward`` spent in kernels that are not the port's own;
- ``trainer_idle_s``: device-idle seconds a training step in gaps that
  open while the innermost program span is a ``tdm.*`` or ``sync`` span
  and no ``blade.dit`` span is open.

``counters()`` reads the program's counters for the per-layer readers.

Run it on a Chrome trace (``--profile PATH`` of the port's CLIs) or on one
traced window of a cell (set-up as ``run.py`` makes it, no check):

    python -m bench_torch.harness.program_trace TRACE.json
    python -m bench_torch.harness.program_trace --workload cogvideox-5b-480p.tdm \\
        --seed 7 --seconds 10
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from typing import Dict, List, Tuple

from bench_torch.harness import trace as T

PREFIX = "blade."
ASA = PREFIX + "asa"
DIT = PREFIX + "dit"
COMPLETE = (PREFIX + "sample", PREFIX + "decode", PREFIX + "tdm.step")
TRAINER = (PREFIX + "tdm.", PREFIX + "sync")


def counters() -> Dict[str, float]:
    """The program's counters (``blade_torch.utils.tracing.counters``), or
    none from a program that keeps none."""
    try:
        from blade_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.counters()


def _instances(index: T._SpanIndex, name: str, t: float) -> int:
    """The span of ``name`` that holds ``t``, by its position, or -1."""
    starts, ends = index.by_name[name]
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and t <= ends[i] else -1


def _innermost(index: T._SpanIndex, t: float) -> str:
    """The shortest program span that holds ``t``, without ``blade.``."""
    best, best_len = None, float("inf")
    for name, (starts, ends) in index.by_name.items():
        i = _instances(index, name, t)
        if i >= 0 and ends[i] - starts[i] < best_len:
            best, best_len = name, ends[i] - starts[i]
    return best[len(PREFIX):] if best else "outside every span"


def reduce_program_trace(events: List[dict], top: int = 10) -> dict:
    """The window's device activity by program span (see module doc)."""
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("tid"))
             for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and str(e.get("name", "")).startswith((PREFIX, T.WINDOW))]
    acts = [e for e in events if e.get("cat") in T.DEVICE_CATS and e.get("ph") == "X"]
    windows = [s for s in spans if s[0] == T.WINDOW]
    spans = [s for s in spans if s[0] != T.WINDOW]
    if not spans:
        raise ValueError("the trace holds no program span")
    if windows:
        w0, w1, main = windows[0][1], windows[0][2], windows[0][3]
    else:
        w0 = min(s[1] for s in spans)
        w1 = max([s[2] for s in spans] + [float(e["ts"]) + float(e.get("dur", 0))
                                          for e in acts])
        main = max(spans, key=lambda s: s[2] - s[1])[3]
    index = T._SpanIndex([s[:3] for s in spans])

    launch, created, nodes = {}, set(), []
    for e in events:
        args = e.get("args", {})
        if e.get("cat") in T.LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = float(e["ts"])
        elif e.get("cat") == "cpu_op" and "Sequence number" in args:
            t = float(e["ts"])
            if e["name"].startswith(T.NODE):
                nodes.append((args["Sequence number"], t, t + float(e.get("dur", 0))))
            elif e.get("tid") == main and ASA in index.by_name and index.holds(ASA, t):
                created.add(args["Sequence number"])
    asa_nodes = T._SpanIndex([(ASA, a, b) for s, a, b in nodes if s in created])

    busy = []
    device = {name: 0.0 for name in index.by_name}
    device[ASA + T.BACKWARD] = 0.0
    asa_port = asa_all = 0.0
    complete = {name: list(index.by_name[name][1]) for name in COMPLETE
                if name in index.by_name}
    for e in acts:
        a, dur = float(e["ts"]), float(e.get("dur", 0))
        lo, hi = max(a, w0), min(a + dur, w1)
        if hi > lo:
            busy.append((lo, hi))
        t_launch = launch.get(e.get("args", {}).get("correlation"))
        if t_launch is None:
            continue
        for name in index.by_name:
            if index.holds(name, t_launch):
                device[name] += dur
        in_asa = ASA in index.by_name and index.holds(ASA, t_launch)
        if not in_asa and ASA in asa_nodes.by_name and asa_nodes.holds(ASA, t_launch):
            device[ASA + T.BACKWARD] += dur
            in_asa = True
        if in_asa:
            asa_all += dur
            if T.kernel_group(e["name"]) in T.port_kernel_names():
                asa_port += dur
        for name, ends in complete.items():
            i = _instances(index, name, t_launch)
            if i >= 0:
                ends[i] = max(ends[i], a + dur)

    merged = T._merge(busy)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    labelled: List[Tuple[str, float, float]] = [(_innermost(index, a), a, b) for a, b in gaps]
    by_span: Dict[str, float] = {}
    for label, a, b in labelled:
        by_span[label] = by_span.get(label, 0.0) + (b - a) * 1e-6
    steps = len(index.by_name.get(PREFIX + "tdm.step", ([], []))[0])
    trainer_idle = sum(
        b - a for label, a, b in labelled
        if (PREFIX + label).startswith(TRAINER)
        and not (DIT in index.by_name and index.holds(DIT, a)))
    labelled.sort(key=lambda g: g[1] - g[2])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in merged) * 1e-6,
        "span_device_s": {n[len(PREFIX):]: s * 1e-6 for n, s in device.items()},
        "complete_s": {n[len(PREFIX):]: sum(e - s for s, e in zip(index.by_name[n][0], ends))
                       * 1e-6 for n, ends in complete.items()},
        "spans": {n[len(PREFIX):]: len(ends) for n, ends in complete.items()},
        "program_idle_gaps": [[label, (b - a) * 1e-6] for label, a, b in labelled[:top]],
        "idle_s_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        "asa_glue_share": 100.0 * (1.0 - asa_port / asa_all) if asa_all else None,
        "trainer_idle_s": trainer_idle * 1e-6 / steps if steps else None,
    }


def _window_of_cell(workload: str, seed: int, seconds: float):
    """One traced window of ``workload`` on CUDA device 0, set up as
    ``run.py`` sets it up: ``(events, driver records, program counters)``."""
    import torch

    from bench_torch.harness.cell import closed_loop
    from bench_torch.harness.registry import Registry
    from blade_torch.utils import tracing

    torch.set_num_threads(4)  # as run.py
    reg = Registry()
    cell = reg.workload(workload)
    traffic = reg.traffic(cell["traffic"])
    driver = reg.module("drivers", traffic["driver"]).Driver(
        reg.config(cell["config"]), traffic, seed=seed, device=torch.device("cuda", 0),
        spans=T.Spans(True), check_steps=reg.limits(workload)["check_steps"])
    driver.warm()
    torch.cuda.synchronize()
    tracing.reset()
    _, events = T.profiled(lambda: closed_loop(driver.issue, seconds))
    return events, driver.records(), tracing.counters()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", nargs="?", help="a Chrome trace (JSON)")
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    if args.workload:
        events, records, counters = _window_of_cell(args.workload, args.seed, args.seconds)
        print("bench spans " + json.dumps(T.reduce_trace(events)))
        print("records " + json.dumps({k: v for k, v in records.items()
                                       if isinstance(v, (int, float))}))
        print("counters " + json.dumps(counters))
    elif args.trace:
        with open(args.trace) as f:
            events = json.load(f)["traceEvents"]
    else:
        p.error("give a trace or --workload")
    print("program spans " + json.dumps(reduce_program_trace(events)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
