#!/usr/bin/env python3
"""Kernel times of the PyTorch port on one NVIDIA GPU: ``chip_smoke.py``'s
kernel checks alone, each kernel against its plain version and, where one
PyTorch call computes the same function, timed in turns with that call.
By default: the forward checks (phases 3, 9 and 15: the Wan2.1-1.3B 480p and
CogVideoX-5B 480p main-path shapes, the "max" predictor, union-gathered
sparse and head-relayout kernels; phase 12 at Wan2.1-14B 720p: the dense
kernel as its predictor, the three pooled levels and the sparse kernel on
the level-1 lists; ``check_wan14b_carry``: the multi-level kernel over the
14B level mask's four lists, the list building alone, and the level carry
whole in turns with the per-level lane whole; the dense kernel as the
CogVideoX pooled branch of phase 18; CogVideoX's q/k lane and its input
gradient, ``check_cog_qk``) and the backward checks (``check_backward``, phase 6: the dense and
sparse backward kernels and the delta kernel at Wan 480p, and the whole
sparse backward as the port runs it; ``check_cog_energy``, phase 18: the
same at CogVideoX d = 64, with its sparse forward and ``pack_kv``) and
``check_wan_cross_attn`` (phase 24: the dense forward and backward over
Wan's 512 text keys, and ``WanCrossAttention`` whole in turns with the
library expression the kernels replaced) and ``check_wan_modulate`` (phase
26: Wan's block glue at the 1.3B's and the 14B's rows, the LayerNorm
kernels in turns with ``F.layer_norm``, and one block's glue whole in turns
with the expression it replaced).

    python3 scripts/torch_kernel_times.py [PHASE ...]

``PHASE`` names ``chip_smoke`` check functions, e.g. ``check_kernels
check_dense_d64`` for the Wan and CogVideoX dense and pack checks alone,
``check_backward check_cog_energy`` for the dense backward at its three
shapes, ``check_cog_multilevel_backward`` for the pooled backward kernels
of phase 19, or ``check_last_kernels`` for the "max" predictor's
one-pass ``wgmma`` kernel at its three shapes and the gather kernel's union
walk beside the 128-row walk on the same mask (phase 15).

Imports ``blade_torch`` from ``PYTHONPATH`` first, so pointing
``PYTHONPATH`` at another checkout times that checkout's kernels with this
checkout's checks; run two checkouts in turns in one session to compare them
on one card.  A check whose modules the package lacks is reported and
skipped; a package without the delta kernel has delta timed in torch.  Prints one JSON line per check (CUDA-event means) and the card's
name and power limit.
"""

import gc
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.append(ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import blade_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, checks = torch.device("cuda"), {}
    names = sys.argv[1:] or ["check_kernels", "check_dense_d64", "check_wan14b_pooled",
                             "check_wan14b_carry", "check_cog_pooled_fwd",
                             "check_cog_multilevel", "check_cog_qk",
                             "check_last_kernels", "check_backward", "check_cog_energy",
                             "check_wan_cross_attn", "check_wan_modulate"]
    for name in names:
        phase = getattr(smoke, name)
        try:
            phase(torch, dev, checks)
        except ImportError as e:
            print(f"{phase.__name__}: not in this package ({e})", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    package = os.path.dirname(blade_torch.__file__)
    for kernel, rows in checks.items():
        for c in rows:
            print(json.dumps({"kernel": kernel, "shape": c["shape"], "ms": c["ms"],
                              "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                              "library_ms": c["library_ms"],
                              "library_call": c.get("library_call"),
                              "max_abs_err": c["max_abs_err"], "package": package}))
    print(smoke._nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
