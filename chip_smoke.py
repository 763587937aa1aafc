#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``blade_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and prints
no result):

1. the card's name and power limit; build the CUDA kernels from
   ``blade_torch/csrc`` (timed);
2. TF32 off for matmuls and cuDNN convs (the reference path is f32);
3. every kernel of the main path against its plain PyTorch version at the
   main-path shapes of Wan2.1-1.3B 480p (B=1, H=12, d=128, L=32760), with
   max |err| against a stated tolerance and both times from CUDA events;
4. the main path: the full-width Wan2.1-T2V-1.3B ``wan-1.3b-480p`` preset on
   random weights from a seeded generator serves two requests through
   ``build_pipeline`` and ``T2VPipeline.generate`` (8 UniPC steps, flow shift
   3, CFG 1, ASA energy lane, f32 streaming VAE decode, uint8 frames); the
   kernels' launch counters are zeroed just before and read just after;
   then one dense forward for comparison;
5. a small-input reference check: the same model code with kernels (bf16,
   on the card) against its plain versions (f32, on the CPU) on shared
   weights and replayed masks.

The second-to-last line is the card's ``name, power.limit``; before it, one
JSON line with the per-kernel results; the last line is the result object.
"""

import json
import math
import os
import subprocess
import sys
import time


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _within(got, want, atol, rtol):
    """max over elements of |got - want| - rtol * |want| <= atol."""
    g, w = got.float(), want.float()
    return ((g - w).abs() - rtol * w.abs()).max().item() <= atol


def check_kernels(torch, dev):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.attention.gilbert import gilbert_permutations
    from blade_torch.kernels._build import KERNELS
    from blade_torch.kernels.block_sparse_attn import (
        block_sparse_attention, flash_attention, flash_attention_wide_v)
    from blade_torch.kernels.norm_rope import _norm_rope_reference, norm_rope_heads
    from blade_torch.kernels.pack import _pack_kv_reference, pack_kv
    from blade_torch.kernels.ref_attention import (
        block_masked_attention, dense_attention_with_lse)
    from blade_torch.models.layers import rope_3d_tables
    from blade_torch.utils.rng import make_generator

    gen = make_generator(1234, dev)
    bf = torch.bfloat16
    h, d, L = 12, 128, 32760

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    # Tolerances (max over elements of |err| - rtol*|ref| <= atol): attention
    # out 2e-2 + 1e-2|ref| (bf16 output rounding, the kernel's bf16 P @ V),
    # lse 5e-3 (f32 sums in another order), norm_rope 2e-2 + 1e-2|ref| (one
    # bf16 ulp of the rounded output), pack bit for bit.
    OUT, LSE, ROPE = (2e-2, 1e-2), (5e-3, 0.0), (2e-2, 1e-2)
    checks = {}

    def record(kernel, shape, ok, err, ms, plain_ms, tol):
        print(f"check {kernel:10s} {shape:44s} max_abs_err={err:.3e} tol={tol} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} {'ok' if ok else 'FAIL'}")
        checks.setdefault(kernel, []).append(
            dict(shape=shape, ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms))
        if not ok:
            raise AssertionError(f"{kernel} at {shape}: max_abs_err {err} over {tol}")

    def attn_check(kernel, shape, fn, plain, reps, plain_reps=1):
        out, lse = fn()
        ref_out, ref_lse = plain()
        ok = _within(out, ref_out, *OUT) and _within(lse, ref_lse, *LSE)
        err = max(_max_err(out, ref_out), _max_err(lse, ref_lse))
        record(kernel, shape, ok, err, _cuda_ms(torch, fn, reps),
               _cuda_ms(torch, plain, plain_reps), "out 2e-2+1e-2|ref|, lse 5e-3")

    # -- dense flash (#1): predictor, pooled branch, dense leg ------------------
    cfg = C.derive_asa_config(C.WAN_480P)
    tokens, nk = cfg.sample_tokens_per_block, 256
    ls = nk * tokens
    qs, ks = randn(1, h, ls, d), randn(1, h, ls, d)
    pool = torch.nn.functional.one_hot(torch.arange(ls, device=dev) // tokens, 256).to(bf)
    pool = pool.expand(1, h, ls, 256).contiguous()
    attn_check("dense_fwd", "predictor q,k [1,12,4096,128] v [1,12,4096,256]",
               lambda: flash_attention_wide_v(qs, ks, pool),
               lambda: dense_attention_with_lse(qs, ks, pool), reps=20, plain_reps=3)
    q, k, v = randn(1, h, L, d), randn(1, h, L, d), randn(1, h, L, d)
    kp = (k.float().reshape(1, h, -1, 30, d).mean(3)).to(bf)
    vp = (v.float().reshape(1, h, -1, 30, d).mean(3)).to(bf)
    attn_check("dense_fwd", "pooled q [1,12,32760,128] k,v [1,12,1092,128]",
               lambda: flash_attention(q, kp, vp, bias=math.log(30.0)),
               lambda: dense_attention_with_lse(q, kp, vp, bias=math.log(30.0)),
               reps=20, plain_reps=3)
    attn_check("dense_fwd", "dense leg q,k,v [1,12,32760,128]",
               lambda: flash_attention(q, k, v),
               lambda: dense_attention_with_lse(q, k, v), reps=3)

    # -- sparse rows (#2) with a mask from the real predictor -----------------
    mask = asa.compute_mask(q, k, cfg, generator=make_generator(7, dev))
    density = mask.float().mean().item()
    attn_check("sparse_fwd", f"q,k,v [1,12,32760,128] density {density:.4f}",
               lambda: block_sparse_attention(q, k, v, mask),
               lambda: block_masked_attention(q, k, v, mask, block_k=128), reps=10)

    # -- pack_kv (#3), bit exact ----------------------------------------------
    kf, vf = randn(h, 32768, d), randn(h, 32768, d)
    got, want = pack_kv(kf, vf), _pack_kv_reference(kf, vf)
    record("pack_kv", "k,v [12,32768,128] -> [12,65536,128]", torch.equal(got, want),
           _max_err(got, want), _cuda_ms(torch, lambda: pack_kv(kf, vf), 50),
           _cuda_ms(torch, lambda: _pack_kv_reference(kf, vf), 50), "bit exact")

    # -- norm_rope (#4) -------------------------------------------------------
    x = randn(1, L, 1536)
    scale = 1.0 + 0.1 * torch.randn(1536, generator=gen, device=dev)
    cos, sin = rope_3d_tables(d, (21, 30, 52))
    perm = gilbert_permutations(52, 30, 21)[0]
    cos = torch.from_numpy(cos[perm]).to(dev)
    sin = torch.from_numpy(sin[perm]).to(dev)
    got = norm_rope_heads(x, scale, cos, sin, h)
    want = _norm_rope_reference(x, scale, cos, sin, h, 1e-6)
    record("norm_rope", "x [1,32760,1536] -> [1,12,32760,128]", _within(got, want, *ROPE),
           _max_err(got, want), _cuda_ms(torch, lambda: norm_rope_heads(x, scale, cos, sin, h), 50),
           _cuda_ms(torch, lambda: _norm_rope_reference(x, scale, cos, sin, h, 1e-6), 20),
           "2e-2+1e-2|ref|")
    assert set(checks) == set(KERNELS), (set(checks), set(KERNELS))
    return checks


def serve(torch, dev):
    """Phase 4: two full 480p requests on the port's main path."""
    from blade_torch.cli.inference import build_pipeline, get_args, random_text_embeds
    from blade_torch.kernels._build import KERNELS, reset_launch_counts
    from blade_torch.models.wan_dit import WanModel
    from blade_torch.utils.rng import make_generator

    args = get_args(["--preset", "wan-1.3b-480p", "--random-init", "--seed", "8888",
                     "--steps", "8"])
    t0 = time.perf_counter()
    pipe = build_pipeline(args)
    torch.cuda.synchronize()
    print(f"pipeline built (random weights, seed 0) in {time.perf_counter() - t0:.2f} s; "
          f"DiT params {sum(p.numel() for p in pipe.dit.parameters()) / 1e9:.3f} B")
    text = random_text_embeds(pipe, "a corgi surfing a wave at sunset")
    assert text.shape == (1, 512, 4096)

    # Measurement shim: time the two halves of generate() on the host clock.
    timed = {}
    sample_latents, decode_latents = pipe.sample_latents, pipe.decode_latents

    def timed_sample(*a, **kw):
        t = time.perf_counter()
        lat = sample_latents(*a, **kw)
        torch.cuda.synchronize()
        timed["denoise_s"] = time.perf_counter() - t
        timed["latents_finite"] = bool(torch.isfinite(lat).all())
        timed["latents"] = lat
        return lat

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        out = decode_latents(*a, **kw)
        torch.cuda.synchronize()
        timed["decode_s"] = time.perf_counter() - t
        return out

    pipe.sample_latents, pipe.decode_latents = timed_sample, timed_decode
    results = []
    reset_launch_counts()
    for i in range(2):
        t = time.perf_counter()
        frames = pipe.generate(text, generator=make_generator(args.seed + i, dev),
                               num_steps=args.steps)
        u8 = pipe.frames_to_uint8(frames)
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t
        assert u8.shape == (1, 81, 480, 832, 3) and u8.dtype == torch.uint8, u8.shape
        assert timed["latents_finite"], "non-finite latents"
        assert torch.isfinite(frames).all()
        r = dict(request=i, denoise_s=timed["denoise_s"],
                 step_ms=1000 * timed["denoise_s"] / args.steps,
                 decode_s=timed["decode_s"], clip_s=clip_s,
                 frames_mean=float(u8.float().mean()), frames_std=float(u8.float().std()))
        print("request " + json.dumps(r))
        results.append(r)
    launches = {name: k.launches for name, k in KERNELS.items()}
    print("launches over the two requests " + json.dumps(launches))
    pipe.sample_latents, pipe.decode_latents = sample_latents, decode_latents
    L, steps = pipe.preset.dit.num_layers, args.steps
    per_clip = {"norm_rope": 2 * L * steps, "sparse_fwd": L * steps, "pack_kv": L * steps}
    for name, n in per_clip.items():
        assert launches[name] == 2 * n, (name, launches[name], 2 * n)
    assert launches["dense_fwd"] >= 2 * 2 * L * steps, launches
    assert all(n > 0 for n in launches.values()), launches

    # One dense forward on the same weights for comparison.
    dense = WanModel(pipe.preset.dit, dtype=pipe.dtype, device=dev).eval()
    dense.load_state_dict(pipe.dit.state_dict())
    lat = timed["latents"]
    tstep = torch.full((1,), 999.0, device=dev)
    with torch.inference_mode():
        dense(lat, tstep, text)
        torch.cuda.synchronize()
        t = time.perf_counter()
        v = dense(lat, tstep, text)
        torch.cuda.synchronize()
        dense_ms = 1000 * (time.perf_counter() - t)
    assert torch.isfinite(v).all()
    print(f"dense forward (one step, same weights) {dense_ms:.1f} ms; sparse step "
          f"{results[1]['step_ms']:.1f} ms (warm request)")
    del dense
    return results, launches, dense_ms


def reference_check(torch, dev):
    """Phase 5: kernels (bf16, card) vs plain versions (f32, CPU) on a small
    input with shared weights and the card's masks replayed on the CPU."""
    from blade_torch.attention.asa import ASAConfig
    from blade_torch.attention.integration import asa_model_kwargs
    from blade_torch.models.wan_dit import WanConfig, WanModel
    from blade_torch.utils.rng import make_generator

    cfg = WanConfig(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32)
    asa = ASAConfig(latent_width=16, latent_height=15, latent_frames=4, sample_gap=30,
                    min_retain_ratio=0.05, max_retain_ratio=0.5)
    card = WanModel(cfg, dtype=torch.bfloat16, device=dev, **asa_model_kwargs(asa)).eval()
    card.random_init_(make_generator(11, dev))
    cpu = WanModel(cfg, dtype=torch.float32, **asa_model_kwargs(asa)).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    g = torch.Generator().manual_seed(12)
    x = torch.randn(1, 16, 4, 30, 32, generator=g)
    text = torch.randn(1, 8, 64, generator=g)
    t = torch.tensor([700.0])
    with torch.inference_mode():
        v_card, masks = card(x.to(dev), t.to(dev), text.to(dev),
                             attn_kwargs={"generator": make_generator(13, dev),
                                          "collect_mask": True})
        v_cpu = cpu(x, t, text, attn_kwargs={"masks": masks.cpu()})
    err = (v_card.float().cpu() - v_cpu).abs().max().item()
    scale = v_cpu.abs().max().item()
    density = masks.float().mean().item()
    print(f"reference check: velocity max_abs_err {err:.4e} (bf16 kernels on the card vs "
          f"f32 plain on the CPU, |ref| max {scale:.3f}, mask density {density:.3f}, "
          f"tol 5e-2*|ref|max)")
    assert torch.isfinite(v_card).all() and 0.0 < density < 1.0
    assert err <= 5e-2 * scale, (err, scale)
    return err


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from blade_torch.kernels import _build
    except ImportError:
        print("chip_smoke: blade_torch not found next to this script", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = _nvidia_smi()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s -> {_build.BUILD_DIR}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    checks = check_kernels(torch, dev)
    results, launches, dense_ms = serve(torch, dev)
    ref_err = reference_check(torch, dev)

    warm = results[1]
    print("summary " + json.dumps(dict(
        card=smi, denoise_s=warm["denoise_s"], step_ms=warm["step_ms"],
        decode_s=warm["decode_s"], clip_s=warm["clip_s"], dense_step_ms=dense_ms,
        cold_clip_s=results[0]["clip_s"], reference_max_abs_err=ref_err)))
    kernels = []
    for name, k in _build.KERNELS.items():
        main_check = checks[name][-1] if name != "dense_fwd" else checks[name][1]
        kernels.append(dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in checks[name]),
            ms=main_check["ms"], plain_ms=main_check["plain_ms"],
            shape=main_check["shape"], checks=checks[name]))
    print(json.dumps({"kernels": kernels}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
