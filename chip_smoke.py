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
   weights and replayed masks;
6. the four backward kernels against the plain backward at main-path
   shapes (the pooled branch, the dense leg, and the sparse branch with a
   mask from the real predictor plus one forced empty row), with a non-zero
   LSE cotangent;
7. a small gradient check, the training twin of phase 5: LoRA gradients of
   one loss with kernels (bf16, card) against plain versions (f32, CPU);
8. the training path: ``blade_torch.cli.train.main`` at full width
   (``wan-1.3b-480p``, 30 layers, random weights, ASA, remat), three TDM
   steps with k_step 2 and CFG 5; finite losses, moved adapters, a frozen
   base, a checkpoint at step 2, and exactly 2 x 30 launches of each
   backward kernel a step (the fake and the generator backward passes).

The second-to-last line is the card's ``name, power.limit``; before it, one
JSON line with the per-kernel results (``launches`` sums the serving and the
training paths, each counted from zero); the last line is the result object.
"""

import json
import math
import os
import subprocess
import sys
import time

SERVE_KERNELS = ("dense_fwd", "sparse_fwd", "pack_kv", "norm_rope")
BACKWARD_KERNELS = ("dense_dq", "dense_dkv", "sparse_dq", "sparse_dkv")


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


def _recorder(checks):
    """``record(kernel, shape, ok, err, ms, plain_ms, tol, main=False)``:
    print one check, keep it in ``checks`` (``main`` marks the shape the
    kernels line reports), raise if it failed."""

    def record(kernel, shape, ok, err, ms, plain_ms, tol, main=False):
        print(f"check {kernel:10s} {shape:44s} max_abs_err={err:.3e} tol={tol} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} {'ok' if ok else 'FAIL'}")
        checks.setdefault(kernel, []).append(
            dict(shape=shape, ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms, main=main))
        if not ok:
            raise AssertionError(f"{kernel} at {shape}: max_abs_err {err} over {tol}")

    return record


def check_kernels(torch, dev, checks):
    """Phase 3: each forward kernel against its plain version at main-path
    shapes."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.attention.gilbert import gilbert_permutations
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
    record = _recorder(checks)

    def attn_check(kernel, shape, fn, plain, reps, plain_reps=1, main=False):
        out, lse = fn()
        ref_out, ref_lse = plain()
        ok = _within(out, ref_out, *OUT) and _within(lse, ref_lse, *LSE)
        err = max(_max_err(out, ref_out), _max_err(lse, ref_lse))
        record(kernel, shape, ok, err, _cuda_ms(torch, fn, reps),
               _cuda_ms(torch, plain, plain_reps), "out 2e-2+1e-2|ref|, lse 5e-3", main)

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
               reps=20, plain_reps=3, main=True)
    attn_check("dense_fwd", "dense leg q,k,v [1,12,32760,128]",
               lambda: flash_attention(q, k, v),
               lambda: dense_attention_with_lse(q, k, v), reps=3)

    # -- sparse rows (#2) with a mask from the real predictor -----------------
    mask = asa.compute_mask(q, k, cfg, generator=make_generator(7, dev))
    density = mask.float().mean().item()
    attn_check("sparse_fwd", f"q,k,v [1,12,32760,128] density {density:.4f}",
               lambda: block_sparse_attention(q, k, v, mask),
               lambda: block_masked_attention(q, k, v, mask, block_k=128), reps=10,
               main=True)

    # -- pack_kv (#3), bit exact ----------------------------------------------
    kf, vf = randn(h, 32768, d), randn(h, 32768, d)
    got, want = pack_kv(kf, vf), _pack_kv_reference(kf, vf)
    record("pack_kv", "k,v [12,32768,128] -> [12,65536,128]", torch.equal(got, want),
           _max_err(got, want), _cuda_ms(torch, lambda: pack_kv(kf, vf), 50),
           _cuda_ms(torch, lambda: _pack_kv_reference(kf, vf), 50), "bit exact", True)

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
           "2e-2+1e-2|ref|", True)


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
    # serving runs no backward kernel
    assert all(launches[n] > 0 for n in SERVE_KERNELS), launches
    assert all(launches[n] == 0 for n in BACKWARD_KERNELS), launches

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


def _small_asa_models(torch, dev, seed):
    """The small ASA model of phases 5 and 7 (2 layers of width 256, 2 heads
    of 128, 960 tokens in 8 blocks) twice on shared random weights:
    bf16 activations on the card, f32 on the CPU; both frozen."""
    from blade_torch.attention.asa import ASAConfig
    from blade_torch.attention.integration import asa_model_kwargs
    from blade_torch.models.wan_dit import WanConfig, WanModel
    from blade_torch.utils.rng import make_generator

    cfg = WanConfig(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32)
    asa = ASAConfig(latent_width=16, latent_height=15, latent_frames=4, sample_gap=30,
                    min_retain_ratio=0.05, max_retain_ratio=0.5)
    card = WanModel(cfg, dtype=torch.bfloat16, device=dev, **asa_model_kwargs(asa))
    card.random_init_(make_generator(seed, dev))
    cpu = WanModel(cfg, dtype=torch.float32, **asa_model_kwargs(asa))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return card.requires_grad_(False).eval(), cpu.requires_grad_(False).eval()


def reference_check(torch, dev):
    """Phase 5: kernels (bf16, card) vs plain versions (f32, CPU) on a small
    input with shared weights and the card's masks replayed on the CPU."""
    from blade_torch.utils.rng import make_generator

    card, cpu = _small_asa_models(torch, dev, 11)
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


def check_backward(torch, dev, checks):
    """Phase 6: the four backward kernels against the plain backward at
    main-path shapes, with random ``g_out`` and a non-zero ``g_lse``."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.kernels.block_sparse_attn import (
        _backward_cuda, block_sparse_attention)
    from blade_torch.kernels.ref_attention import attention_backward_reference
    from blade_torch.utils.rng import make_generator

    gen = make_generator(4321, dev)
    h, d, L = 12, 128, 32760
    scale = 1.0 / math.sqrt(d)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # Tolerance: each gradient's max |err| <= 2e-2 * max |ref|.  The kernels
    # round p and ds to bf16 before each product (2^-9 relative a term, as
    # the TPU kernels feed the MXU) and the gradients to bf16 on output; the
    # plain backward is f32 throughout.
    REL = 2e-2
    record = _recorder(checks)

    def bwd_check(kind, shape, q, k, v, mask, bias, reps, main=False):
        with torch.no_grad():
            out, lse = block_sparse_attention(q, k, v, mask, bias=bias)
        g_out = randn(*q.shape)
        g_lse = torch.randn(lse.shape, generator=gen, device=dev)
        args = (q, k, v, out, lse, g_out, g_lse, mask, scale, bias)
        got = dict(zip(("dq", "dk", "dv"), _backward_cuda(*args)))

        def plain():
            return attention_backward_reference(q, k, v, out, lse, g_out, g_lse,
                                                block_mask=mask, block_k=128,
                                                scale=scale, bias=bias)

        want = dict(zip(("dq", "dk", "dv"), plain()))
        for name in got:
            assert torch.isfinite(got[name].float()).all(), (kind, shape, name)
        if mask is not None:
            empty = (~mask.reshape(-1, mask.shape[-1]).any(-1)).nonzero()
            assert empty.numel(), "the forced empty row is missing"
            for row in empty[:, 0].tolist():
                bh, qb = divmod(row, mask.shape[-2])
                rows = got["dq"].reshape(-1, q.shape[2], d)[bh, qb * 128:(qb + 1) * 128]
                assert rows.float().abs().max().item() == 0.0, "empty row has a gradient"
        plain_ms = _cuda_ms(torch, plain, 1)
        for part, names in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            errs = {n: _max_err(got[n], want[n]) for n in names}
            refs = {n: want[n].float().abs().max().item() for n in names}
            per = ", ".join(f"{n} {errs[n]:.2e}/{refs[n]:.2e}" for n in names)
            ms = _cuda_ms(torch, lambda: _backward_cuda(*args, parts=(part,)), reps)
            record(f"{kind}_{part}", shape, all(errs[n] <= REL * refs[n] for n in names),
                   max(errs.values()), ms, plain_ms,
                   f"2e-2*max|ref| per grad (err/max|ref|: {per}; plain = the whole "
                   "backward)", main)

    q, k, v = randn(1, h, L, d), randn(1, h, L, d), randn(1, h, L, d)
    kp = (k.float().reshape(1, h, -1, 30, d).mean(3)).to(torch.bfloat16)
    vp = (v.float().reshape(1, h, -1, 30, d).mean(3)).to(torch.bfloat16)
    bwd_check("dense", "pooled q,dO [1,12,32760,128] k,v [1,12,1092,128]", q, kp, vp,
              None, math.log(30.0), reps=10, main=True)
    bwd_check("dense", "dense leg q,k,v,dO [1,12,32760,128]", q, k, v, None, 0.0, reps=2)
    cfg = C.derive_asa_config(C.WAN_480P)
    mask = asa.compute_mask(q, k, cfg, generator=make_generator(17, dev))
    mask[0, 5, 100] = False  # one forced empty row
    bwd_check("sparse", f"q,k,v,dO [1,12,32760,128] density "
              f"{mask.float().mean().item():.4f}", q, k, v, mask, 0.0, reps=5, main=True)


def gradient_check(torch, dev):
    """Phase 7: the training twin of phase 5.  LoRA gradients of one loss
    through the small ASA model, kernels (bf16, card) against plain
    versions (f32, CPU), with shared weights and adapters and the card's
    masks replayed."""
    from blade_torch.training.lora import init_lora, merge_lora
    from blade_torch.utils.rng import make_generator

    card, cpu = _small_asa_models(torch, dev, 21)
    g = torch.Generator().manual_seed(22)
    base_cpu = {n: p.detach() for n, p in cpu.named_parameters()}
    # random b factors (init_lora's are zero) so every factor has a gradient
    lora = {k: (v if k.endswith(".a") else 0.05 * torch.randn(v.shape, generator=g))
            for k, v in init_lora(make_generator(23), base_cpu, rank=4).items()}
    x = torch.randn(1, 16, 4, 30, 32, generator=g)
    text = torch.randn(1, 8, 64, generator=g)
    cot = torch.randn(1, 16, 4, 30, 32, generator=g)
    t = torch.tensor([700.0])

    def lora_grads(model, device, **attn_kwargs):
        base = {n: p.detach() for n, p in model.named_parameters()}
        leaves = {k: v.to(device).requires_grad_(True) for k, v in lora.items()}
        out = torch.func.functional_call(
            model, merge_lora(base, leaves, alpha=4.0, rank=4),
            (x.to(device), t.to(device), text.to(device)), {"attn_kwargs": attn_kwargs})
        vel, masks = out if isinstance(out, tuple) else (out, None)
        grads = torch.autograd.grad((vel.float() * cot.to(device)).sum(), list(leaves.values()))
        return {k: gr.float().cpu() for k, gr in zip(leaves, grads)}, masks

    got, masks = lora_grads(card, dev, generator=make_generator(24, dev), collect_mask=True)
    want, _ = lora_grads(cpu, torch.device("cpu"), masks=masks.cpu())
    err = max((got[k] - want[k]).abs().max().item() for k in want)
    ref = max(w.abs().max().item() for w in want.values())
    density = masks.float().mean().item()
    print(f"gradient check: LoRA grads max_abs_err {err:.4e} over {len(want)} factors "
          f"(bf16 kernels on the card vs f32 plain on the CPU, |ref| max {ref:.3f}, "
          f"mask density {density:.3f}, tol 5e-2*|ref|max: bf16 activations through "
          f"two blocks forward and back)")
    assert all(torch.isfinite(v).all() for v in got.values()) and 0.0 < density < 1.0
    assert err <= 5e-2 * ref, (err, ref)
    return err


def train(torch, dev):
    """Phase 8, the training path: ``blade_torch.cli.train.main`` at full
    width (``wan-1.3b-480p``, 32760 tokens, 30 layers) with ASA and remat,
    three TDM steps; launch counters zeroed before and read after each step."""
    import tempfile

    from blade_torch.cli import train as cli
    from blade_torch.kernels._build import KERNELS, reset_launch_counts
    from blade_torch.training.checkpointing import CheckpointManager

    argv = ["--family", "wan", "--random-init", "--batch_size", "1", "--k_step", "2",
            "--cfg", "5.0", "--lambda_reg", "0", "--rank", "64", "--max_train_steps", "3",
            "--checkpointing_steps", "2", "--seed", "42"]
    per_step = []

    def on_step(rec, state):
        per_step.append({name: k.launches for name, k in KERNELS.items()})
        reset_launch_counts()

    with tempfile.TemporaryDirectory(prefix="blade_torch_train_") as out:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        state, history = cli.main(argv + ["--output_dir", out], on_step=on_step)
        peak = torch.cuda.max_memory_allocated()
        steps = CheckpointManager(os.path.join(out, "checkpoints")).all_steps()
        assert os.path.exists(os.path.join(out, "tdm_lora.npz"))
    assert steps == [2], steps
    assert len(history) == 3 and state.step == 3
    for rec in history:
        assert math.isfinite(rec["loss_fake"]) and math.isfinite(rec["loss_du"]), rec
    layers = 30
    for i, counts in enumerate(per_step):
        print(f"train step {i} launches " + json.dumps(counts))
        for name in BACKWARD_KERNELS:  # the fake and the generator backward
            assert counts[name] == 2 * layers, (i, name, counts[name])
        assert all(counts[n] > 0 for n in SERVE_KERNELS), (i, counts)
    # the adapters moved (b starts at zero); the frozen base is bit-unchanged
    moved_g = sum(state.lora_g[k].abs().sum().item() for k in state.lora_g if k.endswith(".b"))
    moved_f = sum(state.lora_f[k].abs().sum().item() for k in state.lora_f if k.endswith(".b"))
    assert moved_g > 0, "lora_g did not move"
    if all(r["fake_skipped"] for r in history):
        print("lora_f: every fake update was skipped by the loss guard")
    else:
        assert moved_f > 0, "lora_f did not move"
    args = cli.get_args(argv + ["--output_dir", "unused"])
    fresh = cli.build_model(args, cli.build_preset(args), dev)
    assert all(torch.equal(p, state.base[n]) for n, p in fresh.named_parameters()), \
        "the frozen base changed"
    del fresh
    warm = [r["step_s"] for r in history[1:]]
    res = dict(s_per_step_warm=sum(warm) / len(warm), step_s=[r["step_s"] for r in history],
               loss_fake=[r["loss_fake"] for r in history],
               loss_du=[r["loss_du"] for r in history],
               fake_skipped=[r["fake_skipped"] for r in history],
               peak_mem_gib=peak / 2**30, lora_g_b_abs_sum=moved_g,
               lora_f_b_abs_sum=moved_f)
    print("train " + json.dumps(res))
    launches = {name: sum(c[name] for c in per_step) for name in KERNELS}
    return res, launches


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

    checks = {}
    check_kernels(torch, dev, checks)
    results, serve_launches, dense_ms = serve(torch, dev)
    ref_err = reference_check(torch, dev)
    check_backward(torch, dev, checks)
    assert set(checks) == set(_build.KERNELS), (set(checks), set(_build.KERNELS))
    grad_err = gradient_check(torch, dev)
    trained, train_launches = train(torch, dev)

    warm = results[1]
    print("summary " + json.dumps(dict(
        card=smi, denoise_s=warm["denoise_s"], step_ms=warm["step_ms"],
        decode_s=warm["decode_s"], clip_s=warm["clip_s"], dense_step_ms=dense_ms,
        cold_clip_s=results[0]["clip_s"], reference_max_abs_err=ref_err,
        gradient_max_abs_err=grad_err, train_s_per_step=trained["s_per_step_warm"],
        train_peak_mem_gib=trained["peak_mem_gib"])))
    kernels = []
    for name, k in _build.KERNELS.items():
        main_check = next(c for c in checks[name] if c["main"])
        kernels.append(dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=serve_launches[name] + train_launches[name],
            launches_by_path={"serve": serve_launches[name],
                              "train": train_launches[name]},
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
