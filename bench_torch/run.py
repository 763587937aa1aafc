#!/usr/bin/env python3
"""Runs one cell of ``BENCHMARK.json`` once on NVIDIA GPUs and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and with ``--trace 1`` a ``breakdown``), then ``checks``.

    python3 bench_torch/run.py --workload wan-1.3b-480p.t2v --seed 7 \\
        --seconds 10 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  ``setup_s`` runs from the start
of this script to the start of the window.  Without a CUDA device, or with
fewer devices than the cell asks for, it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernel library builds into ``build/blade_torch_kernels``)."""
    base = REPO / "build" / "bench_torch"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _cache_dirs()
    sys.path.insert(0, str(REPO))
    import torch

    from bench_torch.harness.cell import run_cell
    from bench_torch.harness.registry import Registry

    reg = Registry()
    chips = reg.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    return run_cell(reg, args.workload, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=torch.device("cuda", 0), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
