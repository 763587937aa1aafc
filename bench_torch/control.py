#!/usr/bin/env python3
"""Readings that set a cell's limits: for each seed, the cell's work
through its timed path (a clip; the steps the check follows), then the
gaps of the program and of the control (the reference a precision lower,
put in the program's place on the same inputs) to the reference.  One
JSON line a seed.

    python3 bench_torch/control.py --workload wan-1.3b-480p.t2v --seeds 11 12 13
    python3 bench_torch/control.py --workload cogvideox-5b-480p.tdm --seeds 11 12 13

The lower end of a limit is the largest program reading over a dozen seeds
or more, the upper end the smallest control reading (``PERF.md``).  The
benchmark's own runs never run the control.
"""

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from bench_torch.harness.registry import Registry
    from bench_torch.harness.trace import Spans

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    cell = reg.workload(args.workload)
    config, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    limits = reg.limits(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        driver = reg.module("drivers", traffic["driver"]).Driver(
            config, traffic, seed=seed, device=dev, spans=Spans(False),
            check_steps=limits["check_steps"])
        driver.control_unit()
        t1 = time.perf_counter()
        got = driver.check(limits["check_steps"], control=True)
        t2 = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": got,
                          "unit_s": t1 - t0, "check_s": t2 - t1,
                          "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}),
              flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
