"""One run of one cell: set-up, the measured window, the readings, the
comparison that decides ``correct``, and the last line.

A driver (``drivers/<kind>.py``, class ``Driver``) gives the harness:

- ``Driver(config, traffic, seed=, device=, spans=, check_steps=)``:
  builds the program's object for the cell, weights and inputs from the
  seed (``check_steps``: the limits file's, for a driver whose set-up
  takes the readings the check compares);
- ``warm()``: the cell's own work before the window (a clip; the steps the
  check follows), so that every shape is built and warm;
- ``control_unit()``: what a control reading runs before ``check``;
- ``issue(i)``: unit ``i`` of the window, ending in ``synchronize``;
- ``end_to_end(window_s, units)``: the cell's rate or time per unit;
- ``records()``: what the per-layer readers take (host spans, counts);
- ``check(check_steps)``: frees the program's state, runs the plain
  reference over a sample drawn from the seed, and returns the numbers it
  compared by name; ``limits/<workload>.json`` gives each its limit.
"""

from __future__ import annotations

import json
import math
import sys
import time
import traceback
from typing import Callable, Tuple

import torch

from bench_torch.harness.registry import Registry
from bench_torch.harness.trace import Spans, profiled, reduce_trace


def closed_loop(issue: Callable[[int], None], seconds: float) -> Tuple[float, int, int]:
    """One client: units issued back to back until ``seconds`` have passed,
    every unit issued counted in full.  Returns ``(window_s, attempted,
    failed)``; the window runs from the first issue to the last completion.
    A unit that raises ends the window (the run is then not correct)."""
    t0 = time.perf_counter()
    n = failed = 0
    while True:
        n += 1
        try:
            issue(n - 1)
        except Exception:  # the program failed a unit: count it, stop issuing
            traceback.print_exc()
            failed += 1
            break
        if time.perf_counter() - t0 >= seconds:
            break
    return time.perf_counter() - t0, n, failed


def device_info(device: torch.device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips}
    return {"platform": device.type, "kind": device.type, "count": chips}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(reg: Registry, workload: str, *, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, out=None, err=None) -> int:
    """Runs the cell once and prints its result; returns the exit code."""
    out, err = out or sys.stdout, err or sys.stderr
    cell = reg.workload(workload)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    limits = reg.limits(workload)
    spans = Spans(trace)
    driver = reg.module("drivers", traffic["driver"]).Driver(
        config, traffic, seed=seed, device=device, spans=spans,
        check_steps=limits["check_steps"])
    driver.warm()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        (window_s, attempted, failed), events = profiled(
            lambda: closed_loop(driver.issue, seconds))
    else:
        window_s, attempted, failed = closed_loop(driver.issue, seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    done = attempted - failed

    dev = device_info(device, cell["chips"])
    dev["memory_peak_bytes"] = int(peak)
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {},
              "device": dev}
    if trace:
        records = dict(driver.records(), trace=reduce_trace(events))
        dev["busy_s"] = records["trace"]["busy_s"]
        dev["window_s"] = records["trace"]["window_s"]
        for m in reg.per_layer(workload):
            value = reg.module("metrics", m["name"]).read(records)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": records["trace"]["device_ops"],
                               "idle_gaps": records["trace"]["idle_gaps"]}
        print("device seconds by span " + json.dumps(records["trace"]["span_device_s"]),
              file=err)
        print("largest ungrouped kernels " + json.dumps(records["trace"]["other"]), file=err)
    else:
        e2e = dict(driver.end_to_end(window_s, max(done, 1)),
                   peak_mem_gib=peak / 2**30, setup_s=setup_s)
        for m in reg.end_to_end(workload):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    checks = []
    if done:
        got = driver.check(limits["check_steps"])
        checks = [(name, got[name], float(lim)) for name, lim in limits["limits"].items()]
    correct = failed == 0 and bool(checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    result["correct"] = correct
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=err)
    print(f"correct {correct}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
