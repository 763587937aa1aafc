#!/usr/bin/env python3
"""Where the time of one serving request goes on one NVIDIA GPU.

    python3 scripts/torch_profile.py                       # CogVideoX-5B 480p
    python3 scripts/torch_profile.py --preset wan-14b-720p --mask_mode multilevel

Builds the named pipeline of the PyTorch port (random weights from seed 0,
the preset's ASA lane unless ``--mask_mode`` names one), then runs
``torch.profiler`` over (1) one warm DiT forward at a mid-schedule timestep
and (2) one warm f32 VAE decode of random latents.  For each it prints the
host wall time (ending in ``synchronize``), the device time by kernel group
and the largest kernels, the device busy share (the summed kernel time over
the wall time; one stream, so kernels do not overlap) and the peak device
memory.
"""

import json
import os
import subprocess
import sys
import time

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("multilevel kernel", ("multilevel_fwd",)),
    ("pooled-level kernel", ("pooled_level_fwd",)),
    ("pyramid pack", ("pack_kv_pyramid",)),
    ("pack_kv", ("pack_kv_kernel",)),
    ("norm_rope", ("norm_rope_kernel",)),
    ("sparse kernel (level 1)", ("attn_fwd_kernel<128, 128, true>",
                                 "attn_fwd_kernel<64, 64, true>")),
    ("dense kernel (predictor)", ("attn_fwd_kernel",)),
    ("convolution", ("conv", "fprop", "implicit", "winograd", "fft", "cudnn")),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "ampere_", "cublas")),
    ("norm", ("layer_norm", "group_norm", "norm", "Moments", "FusedParams")),
    ("copy / cat / index", ("copy_kernel", "CatArray", "index", "gather", "scatter",
                            "Memcpy", "Memset")),
    ("elementwise / reduce", ("elementwise", "reduce")),
)


def _group(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def _profile(torch, label, fn, top=12):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1000 * (time.perf_counter() - t)
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((evt.key, dev_us / 1000.0, evt.count))
    busy = sum(r[1] for r in rows)
    groups = {}
    for name, ms, _ in rows:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"== {label}: wall {wall_ms:.1f} ms, device kernels {busy:.1f} ms, "
          f"busy share {busy / wall_ms:.3f}, peak {peak_gib:.2f} GiB")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"   {g:28s} {ms:10.2f} ms  {ms / busy:6.1%}")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"   {ms:10.2f} ms  x{count:<5d} {name[:110]}")
    return dict(label=label, wall_ms=wall_ms, device_ms=busy, peak_gib=peak_gib,
                groups=groups)


def main():
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="cogvideox-5b-480p")
    p.add_argument("--mask_mode", choices=["energy", "multilevel"], default=None)
    args = p.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from blade_torch.cli.inference import build_pipeline, get_args, random_text_embeds
    from blade_torch.utils.rng import make_generator

    dev = torch.device("cuda")
    argv = ["--preset", args.preset, "--random-init"]
    if args.mask_mode:
        argv += ["--mask_mode", args.mask_mode]
    pipe = build_pipeline(get_args(argv))
    text = random_text_embeds(pipe, "a corgi surfing a wave at sunset")
    gen = make_generator(1, dev)
    lat = torch.randn(pipe.latent_shape(1), generator=gen, device=dev).to(pipe.dtype)
    tstep = torch.full((1,), 499.0, device=dev)
    out = []
    with torch.inference_mode():
        out.append(_profile(torch, f"{args.preset} DiT forward (ASA {pipe.mask_mode} lane)",
                            lambda: pipe.dit(lat, tstep, text, attn_kwargs={
                                "generator": make_generator(2, dev)})))
        out.append(_profile(torch, f"{args.preset} VAE decode (f32)",
                            lambda: pipe.decode_latents(lat.float())))
    print(json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
