#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``blade_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and prints
no result):

1. the card's name and power limit; build the CUDA kernels from
   ``blade_torch/csrc`` (timed);
2. TF32 off for matmuls and cuDNN convs (the reference path is f32);
3. every kernel of the Wan paths against its plain PyTorch version at the
   main-path shapes of Wan2.1-1.3B 480p (B=1, H=12, d=128, L=32760), with
   max |err| against a stated tolerance, both times from CUDA events, the
   least time the card could take (``bound_ms``) and, where one PyTorch call
   computes the same function, that call's time (``library_ms``; for the
   sparse kernel one memory-efficient SDPA with the block mask expanded to
   an additive token mask; the attention and ``pack_kv`` kernels and their
   library calls are timed in turns, A B B A);
4. the main path: the full-width Wan2.1-T2V-1.3B ``wan-1.3b-480p`` preset on
   random weights from a seeded generator serves two requests through
   ``build_pipeline`` and ``T2VPipeline.generate`` (8 UniPC steps, flow shift
   3, CFG 1, ASA energy lane, f32 streaming VAE decode, uint8 frames); the
   kernels' launch counters are zeroed just before and read just after
   (a layer a step: two ``norm_rope``, one sparse and one pack; the text
   cross-attention's three ``heads_pack``, one ``heads_unpack`` and one more
   dense forward); then one dense forward for comparison;
5. a small-input reference check: the same model code with kernels (bf16,
   on the card) against its plain versions (f32, on the CPU) on shared
   weights and replayed masks;
6. the four backward kernels against the plain backward at main-path
   shapes (the pooled branch, the dense leg, and the sparse branch with a
   mask from the real predictor plus one forced empty row and one key
   block no row selected, both of which must get exactly zero gradient),
   with a non-zero LSE cotangent, each timed on its own and in turns with
   one library backward computing dQ, dK and dV (the dense pair: the faster
   of the flash-attention and the cuDNN SDPA backward ops; the sparse pair:
   the memory-efficient SDPA backward with the additive token mask); the
   delta kernel (``delta = rowsum(dO * O)``, which both share) against its
   plain version and timed apart; the sparse backward also timed whole, as
   the port runs it (delta, the lists, the transposed lists, both kernels);
7. a small gradient check, the training twin of phase 5: LoRA gradients of
   one loss with kernels (bf16, card) against plain versions (f32, CPU);
8. the training path: ``blade_torch.cli.train.main`` at full width
   (``wan-1.3b-480p``, 30 layers, random weights, ASA, remat), three TDM
   steps with k_step 2 and CFG 5; finite losses, moved adapters, a frozen
   base, a checkpoint at step 2, and exact launch counts a step: 2 x 30 of
   each sparse backward kernel and 4 x 30 of each dense one (the fake and
   the generator backward passes; the dense pair for the pooled branch and
   the text cross-attention), 6 x 30 of the delta kernel (the sparse and the
   pooled branch and the cross-attention of each), 10 x 30 of ``pack_kv``
   (the forwards only: the sparse backward reads K/V in place), and the
   cross-attention's relayouts (3 ``heads_pack`` and 1 ``heads_unpack`` a
   forward, 1 and 3 a backward);
9. the kernels of the CogVideoX path against their plain versions at
   CogVideoX-5B 480p shapes (B=1, H=48, d=64, L=17776, q_rows 256, lists
   from the real predictor): the multi-level kernel, the pyramid pack, the
   dense kernel at d=64 (predictor and dense leg); the multi-level kernel
   and the pyramid pack also at Wan 480p shapes (d=128, L=32760); the
   multi-level kernel timed in turns with one masked SDPA over the
   concatenated level keys ``[K; K2; K4; K8]`` (a 0 / log L / -inf token
   mask: every level in one softmax); CogVideoX's q/k lane (per-head
   LayerNorm, video RoPE and head split for q and k in one launch) and its
   input gradient at [1, 17776, 3072], each in turns with its plain version,
   and ``dit.qkv`` outside its GEMMs in turns with the composition it
   replaced;
10. the CogVideoX serving path: the full-width, full-depth
   ``cogvideox-5b-480p`` preset (42 blocks, dim 3072, 48 heads of 64) on
   random weights serves two requests through ``build_pipeline`` and
   ``T2VPipeline.generate`` (8 SDE-DPM++(2M) steps, CFG 1, the multilevel
   ASA lane, the f32 CogVideoX VAE decode, tiled and in fb=2 chunks, uint8
   frames ``(1, 49, 480, 720, 3)``), with exact launch counts (672 each of
   the multi-level kernel, the pyramid pack, the dense kernel, the q/k lane
   and ``heads_pack``; no other kernel), then one dense-attention forward
   for ``dense_step_ms``;
11. a small-input reference check of the CogVideoX model: kernels (bf16,
   card) against plain versions (f32, CPU) with shared weights and the
   card's lists replayed;
12. the dense kernel as the Wan2.1-14B 720p predictor (q,k [1,40,9456,128],
   V width 640; the plain version on 4 heads), ``pack_kv`` at 14B K/V
   shapes (against ``torch.stack``) and ``norm_rope`` at the 14B q/k
   width (x [1,75600,5120] -> [1,40,75600,128]); the pooled-level kernel
   against its plain version at Wan2.1-14B 720p shapes (B=1, H=40, d=128,
   L=75600, a level mask from the real predictor), once for each of levels
   2, 4 and 8, and the sparse kernel on the level-1 lists (its plain
   version on 4 heads); then the whole multilevel lane as routed (the
   level carry) and dense flash attention at that shape, timed; then the
   level carry at that shape: the multi-level kernel alone over the
   mask's four lists against its plain version on 4 heads, the list
   building alone, and the carry whole (lists, pyramid pack, one
   multi-level launch) in turns with the per-level lane whole
   (``fused=False``: pack, sparse, pyramid pack, three pooled-level
   launches, the f32 merge);
13. the Wan2.1-14B serving path: the full-width, full-depth
   ``wan-14b-720p`` preset with ``--mask_mode multilevel`` (40 blocks, dim
   5120, 40 heads of 128, 591 key blocks: the level carry) on random
   weights, bf16 projections, serves one request after a warm-up forward
   (8 UniPC steps, flow shift 5, CFG 1, f32 streaming VAE decode, uint8
   frames ``(1, 81, 720, 1280, 3)``), with exact launch counts (320 each of
   the multi-level and pyramid-pack kernels and ``heads_unpack``, 640 dense
   (the predictor and the text cross-attention) and norm_rope, 960
   ``heads_pack``; no sparse, pack or pooled-level kernel, no other kernel)
   and the peak memory of the denoise and of the decode apart, then one
   dense-attention forward of the same module;
14. a small-input reference check past the fused lane's rule: a 2-layer Wan
   with one head of 128 over 273 key blocks, kernels (bf16, card: the
   level carry) against plain versions (f32, CPU: the per-level lane),
   shared weights, the card's int level masks replayed: the velocity and
   the LoRA gradients of one loss;
15. the last three kernels against their plain versions: the "max"
   predictor's pooled-scores kernel (one pass over the sampled keys on
   ``wgmma``) at Wan 480p with 32 and 16 tokens a block and at CogVideoX
   480p with 32; the union-gathered sparse forward (the gather kernel's
   union walk) at Wan 480p on a mask from the real predictor with one
   forced empty row, timed in turns with one masked SDPA on that mask,
   beside the 128-row sparse kernel on the same mask; the head relayouts
   ``heads_pack`` / ``heads_unpack``, bit exact, at the Wan 1.3B and 14B
   q/k widths (CogVideoX's v takes them);
16. path (a), the reference-parity predictor: the ``wan-1.3b-480p`` preset
   with ``asa_predictor="max"`` and 32 sampled tokens a block serves two
   requests through ``build_pipeline`` and ``T2VPipeline.generate``, with
   exact launch counts a request (240 each of the predictor, sparse and
   pack kernels and ``heads_unpack``, 480 dense and norm_rope, 720
   ``heads_pack``; no other kernel) and every mask's
   density; then a small-input reference check with ``predictor="max"``,
   kernels (bf16, card) against plain versions (f32, CPU), the card's
   sampled offsets replayed;
17. path (b), the union-gathered sparse forward: the stock preset with
   ``block_sparse_attn.SPARSE_UNION`` set serves one request after a warm-up
   forward, with exact launch counts (240 union kernel and
   ``heads_unpack``, 720 dense and ``heads_pack``, 480 norm_rope, no 128-row
   sparse kernel and no pack: the union kernel reads K/V in place);
18. the d = 64 forms of the energy lane's kernels at CogVideoX-5B 480p
   training shapes (H=48, L=17776 with the 226 text tokens, an energy mask
   from the real predictor): the dense forward on the pooled branch (1186
   pooled keys, +log 15 bias), the sparse forward, ``pack_kv``, the sparse
   backward and the dense backward on the pooled branch, each backward pair
   timed in turns with its library backward, and delta, as in phase 6;
19. the pooled backward kernels (the multilevel backward) against their
   plain version at CogVideoX-5B 480p fused-lane shapes (p from the merged
   lse), levels 2, 4 and 8, each pair timed in turns with one
   memory-efficient SDPA backward over that level's pooled K/V (token mask
   log L / -inf, the merged out and lse as its saved outputs), then the
   fused lane's dQ, dK, dV against torch
   autograd of its plain version on 4 heads, and its forward and backward
   timed on all 48;
20. the same at Wan2.1-14B 720p per-level shapes (p from each level's own
   lse; the plain version on 8 heads for the kernels, 2 for the lane),
   the per-level lane forced by ``fused=False``; then the level carry's
   output against the per-level lane's on the same real predictor mask,
   and the carry's gradient as the lane's;
21. a small-input gradient check on the fused multilevel lane, the twin of
   phase 7 (phase 14 holds the gradient past the fused rule): LoRA
   gradients through the 2-layer CogVideoX of phase 11, kernels (bf16,
   card) against plain versions (f32, CPU), the card's lists replayed;
22. one full-width LoRA gradient of CogVideoX-5B 480p on its serving lane
   (42 blocks, fused multilevel, q_rows 256, remat): finite, timed, peak
   memory, and exactly a layer one each of ``sparse_dq``, ``sparse_dkv``
   and the delta kernel (shared by the four passes), the q/k lane's dx
   and ``heads_unpack``, three each of the pooled backward kernels, two
   each of the forward's predictor, pyramid pack, multi-level kernel, q/k
   lane and ``heads_pack``, and no ``pack_kv``;
23. the CogVideoX training path: ``blade_torch.cli.train.main`` at full
   width (``--family cogvideox``, 42 blocks, random weights, ASA energy
   lane, remat, the DDPM family) for three TDM steps at the CLI defaults
   (k_step 2, CFG 3.5, lambda_reg 0.5); finite losses, moved adapters, a
   frozen base, exact launch counts a step (11 DiT forwards of 42 layers,
   two backward passes: 11 x 42 ``pack_kv``, q/k lane and ``heads_pack``,
   4 x 42 delta, 2 x 42 of the q/k lane's dx and ``heads_unpack``);
24. Wan's text cross-attention over its 512 text keys: the dense kernel at
   the Wan2.1-1.3B 480p and 14B 720p query counts (the 14B's plain version
   on 4 heads) and the dense backward pair at 1.3B, each against its plain
   version and in turns with its library call; then ``WanCrossAttention``
   whole (projections, q/k RMS norms, relayouts, attention) at both widths,
   forward and (1.3B) forward with backward, against and in turns with the
   library expression the kernels replaced (f32 scores, softmax, bf16 P @ V);
25. image to video: the kernels of its path at its 40 heads over 32,760
   tokens against their plain versions on every head (#1 over the 257
   image keys, whose last key tile holds one key, and as the energy lane's
   predictor and pooled branch; #2 on the preset's own predictor's mask,
   without its library call, whose token mask would take 86 GB; ``pack_kv``
   over the ragged 32,760 keys, bit for bit); then one full-width,
   full-depth Wan2.1-I2V-14B 480p request
   (``wan-i2v-14b-480p``: a first frame and CLIP features drawn from the
   seed, the f32 streaming VAE encode, 8 UniPC steps on the energy lane,
   the decode) through ``build_pipeline``, ``image_inputs`` and
   ``T2VPipeline.generate`` under a CPU profiler, so the program counts:
   exact launch counts (a layer a step: four dense forwards -- the
   predictor, the pooled branch, the text and the image cross-attention --,
   one sparse, one pack, two ``norm_rope``, five ``heads_pack``, one
   ``heads_unpack``) and the counter ``dit.cross_attn.image_calls`` one a
   layer a step;
26. Wan's block glue (``csrc/adaln.cu``) at the 1.3B's and the 14B's rows:
   ``norm_affine``, ``add_norm_affine`` and ``gated_add`` against their
   plain versions (residual outputs bit for bit, normed ones within one
   bf16 ulp of the row), the first and the last in turns with their
   library call (``F.layer_norm``, ``torch.addcmul``), then one block's
   glue whole in turns with the expression it replaced.  Every Wan path
   above counts the glue's launches exactly where autograd records
   nothing: a block's ``norm_affine``, two ``add_norm_affine`` and one
   ``gated_add``, and the head's ``norm_affine``, a forward (phase 8: the
   no-grad forwards of a step alone; phase 25 also the counter
   ``dit.modulate.fused_calls`` one a layer a step).

The second-to-last line is the card's ``name, power.limit``; before it, one
JSON line with the per-kernel results (``launches`` sums the nine paths,
each counted from zero; ``launches_by_path`` splits them); the summary line
before that ends with the script's wall time.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time

SERVE_KERNELS = ("dense_fwd", "sparse_fwd", "pack_kv", "norm_rope")
BACKWARD_KERNELS = ("dense_dq", "dense_dkv", "sparse_dq", "sparse_dkv")
COG_KERNELS = ("multilevel_fwd", "pack_kv_pyramid", "dense_fwd", "qk_norm_rope", "heads_pack")
# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate
# and HBM3 bandwidth.  bound_ms = max(operations / rate, bytes / bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _glue_launches(layers, forwards):
    """The block glue's launches over ``forwards`` no-grad Wan forwards of
    ``layers`` blocks: a block's four (``norm_affine``, ``add_norm_affine``
    twice, ``gated_add``) and the head's ``norm_affine``."""
    return {"norm_affine": (layers + 1) * forwards, "add_norm_affine": 2 * layers * forwards,
            "gated_add": layers * forwards}


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


def _cuda_ms_turns(torch, fns, reps):
    """Mean ms of each of ``fns`` over two turns, in order and then reversed
    (A B B A), so that no side always runs first after a heavy phase: the
    way a kernel is compared with its library call."""
    totals = [0.0] * len(fns)
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        totals[i] += _cuda_ms(torch, fns[i], reps)
    return [t / 2 for t in totals]


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _within(got, want, atol, rtol):
    """max over elements of |got - want| - rtol * |want| <= atol."""
    g, w = got.float(), want.float()
    return ((g - w).abs() - rtol * w.abs()).max().item() <= atol


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the least time for ``flops`` bf16 tensor-core
    operations and ``nbytes`` of device-memory traffic."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _recorder(checks):
    """``record(kernel, shape, ok, err, ms, plain_ms, tol, main=False,
    flops=0, nbytes=0, library_ms=None, library_call=None)``: print one
    check with its bound, keep it in ``checks`` (``main`` marks the shape
    the kernels line reports; ``library_call`` names the call behind
    ``library_ms`` where it is not the plain SDPA), raise if it failed."""

    def record(kernel, shape, ok, err, ms, plain_ms, tol, main=False, flops=0.0,
               nbytes=0, library_ms=None, library_call=None):
        bound_ms, bound_by = _bound(flops, nbytes)
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        if library_call:
            lib += f" ({library_call})"
        print(f"check {kernel:15s} {shape:52s} max_abs_err={err:.3e} tol={tol} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}) library_ms={lib} {'ok' if ok else 'FAIL'}")
        checks.setdefault(kernel, []).append(
            dict(shape=shape, ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                 library_call=library_call, flops=flops, bytes=nbytes, main=main))
        if not ok:
            raise AssertionError(f"{kernel} at {shape}: max_abs_err {err} over {tol}")

    return record


def _block_pairs(mask, lq, lk):
    """Query-key pairs a 128 x 128 block mask selects (rows past ``lq`` and
    keys past ``lk`` excluded)."""
    import torch

    n_qt, n_kt = mask.shape[-2:]
    rows = (lq - 128 * torch.arange(n_qt, device=mask.device)).clamp(max=128)
    keys = (lk - 128 * torch.arange(n_kt, device=mask.device)).clamp(max=128)
    return float((mask.double() * rows[:, None] * keys[None, :]).sum())


def _level_pairs(idx, cnt, lq, lk, level, q_rows):
    """Query-key pairs one level's lists select (``idx [..., n_q, cap]``,
    ``cnt [..., n_q]``): level-L keys are pooled rows, those past
    ``ceil(lk / L)`` and rows past ``lq`` excluded."""
    import torch

    n_q, cap = idx.shape[-2], idx.shape[-1]
    rows = (lq - q_rows * torch.arange(n_q, device=idx.device)).clamp(max=q_rows)
    seg = 128 // level
    keys = (-(-lk // level) - seg * idx.long()).clamp(0, seg)
    live = torch.arange(cap, device=idx.device) < cnt[..., None]
    return float(((keys * live).sum(-1).double() * rows).sum())


def _row_blocks(mask):
    """'blocks a row min/mean/max' of a block mask: the spread of the gather
    kernels' CTA lengths."""
    cnt = mask.sum(-1).float()
    return (f"blocks a row {cnt.min().item():.0f}/{cnt.mean().item():.1f}/"
            f"{cnt.max().item():.0f}")


def _multilevel_pairs(idx, cnt, lq, lk, q_rows):
    """Query-key pairs the four per-level lists select (levels 1, 2, 4, 8)."""
    return sum(_level_pairs(idx[..., li, :], cnt[..., li], lq, lk, level, q_rows)
               for li, level in enumerate((1, 2, 4, 8)))


# Attention tolerances.  out: max |err| <= 2e-2 * max |ref|, held against the
# output's own scale: one bf16 ulp at the largest output is 2^-8 to 2^-7 of
# it, so this allows 2.5 to 5 ulps there, where the kernel rounds P to bf16
# before P @ V and its output to bf16 (measured: about one ulp).  lse:
# max |err| <= 5e-3 (f32 sums in another order).
OUT_REL, LSE_ATOL = 2e-2, 5e-3

# CogVideoX-5B 480p attention (config.COGVIDEOX_480P): 48 heads of 64 over
# 13*30*45 video + 226 text tokens; the predictor samples 16 tokens a 128-key
# block.  Literal so that the dense d = 64 checks also time a checkout that
# has no CogVideoX config (scripts/torch_kernel_times.py).
COG_HEADS, COG_HEAD_DIM, COG_TOKENS, COG_SAMPLE = 48, 64, 17776, 16


def _attn_check(torch, record, kernel, shape, fn, plain, reps, plain_reps=1, main=False,
                flops=0.0, nbytes=0, library=None, heads=None):
    """One attention kernel check: ``fn`` and ``plain`` return ``(out, lse)``;
    ``nbytes`` counts the inputs (the outputs are added here).  With
    ``heads``, ``plain`` covers only the first ``heads`` heads (dim 1) and
    is held against those of the kernel's output."""
    out, lse = fn()
    ref_out, ref_lse = plain()
    hs = slice(0, heads)
    err_out, err_lse = _max_err(out[:, hs], ref_out), _max_err(lse[:, hs], ref_lse)
    ref_max = ref_out.float().abs().max().item()
    ok = err_out <= OUT_REL * ref_max and err_lse <= LSE_ATOL
    if library is None:
        ms, lib_ms = _cuda_ms(torch, fn, reps), None
    else:
        ms, lib_ms = _cuda_ms_turns(torch, [fn, library], reps)
    record(kernel, shape, ok, max(err_out, err_lse), ms, _cuda_ms(torch, plain, plain_reps),
           f"out {err_out:.3e} <= 2e-2*max|ref| ({ref_max:.4e}), lse {err_lse:.3e} <= 5e-3",
           main, flops, nbytes + _nbytes(out, lse), lib_ms)


def _token_mask(torch, shape, rows, band, device):
    """A bf16 additive token mask ``[B, H, length, keys]`` (``shape``) for one
    SDPA call, filled ``rows`` query rows at a time: ``band(i)`` gives the
    values ``[B, H, keys]`` of rows ``[i * rows, (i + 1) * rows)``.  Rows are
    padded to a multiple of 16 elements (the fused kernels' alignment; the
    view hides the padding).  Built outside any timed region."""
    b, h, length, keys = shape
    out = torch.empty((b, h, length, -(-keys // 16) * 16), dtype=torch.bfloat16,
                      device=device)
    for i in range(-(-length // rows)):
        dst = out[:, :, rows * i:rows * (i + 1), :keys]
        dst.copy_(band(i)[:, :, None, :].expand_as(dst))
    return out[..., :keys]


def _additive_mask(torch, mask, length, seg=128, keys=None, value=0.0):
    """The block mask ``[B, H, n_qt, n_kt]`` (128-row mask rows, blocks of
    ``seg`` keys) expanded to the token mask that one SDPA call takes: bf16
    ``[B, H, length, keys]`` (``keys`` defaults to ``length``), ``value``
    (0, or a pooled level's ``log L`` bias) where a key is selected and -inf
    elsewhere.  25.8 GB at Wan 480p, 30.3 GB at CogVideoX, 57.2 GB at the
    14B level 8 (``seg`` 16), 15.2 / 7.6 / 3.8 GB at the CogVideoX pooled
    levels 2 / 4 / 8."""
    b, h = mask.shape[:2]
    keys = length if keys is None else keys
    val = torch.full((), value, dtype=torch.bfloat16, device=mask.device)
    ninf = torch.full((), float("-inf"), dtype=torch.bfloat16, device=mask.device)

    def band(i):
        return torch.where(mask[:, :, i].repeat_interleave(seg, dim=-1)[..., :keys], val, ninf)

    return _token_mask(torch, (b, h, length, keys), 128, band, mask.device)


def _multilevel_library(torch, q, records, idx, cnt, length, q_rows):
    """The library call of the fused multi-level forward (#11): one masked
    SDPA over the concatenated level keys ``[K; K2; K4; K8]`` (the
    ``pack_kv_pyramid`` records), every level in one softmax, the token mask
    0 / ``log L`` / -inf (``multilevel_lists_attention``'s columns).  56.9 GB
    at CogVideoX, 48.3 GB at Wan 480p; freed with the returned call."""
    from blade_torch.kernels.ref_attention import lists_to_level_masks

    h, d = q.shape[1], q.shape[3]
    n_kt = -(-length // 128)
    keys, vals, col_level, col_block, col_ok, col_val = [], [], [], [], [], []
    for li, (level, rec) in enumerate(zip((1, 2, 4, 8), records)):
        seg = 128 // level
        pooled = rec.view(h, n_kt, 2, seg, d)
        keys.append(pooled[:, :, 0].reshape(h, n_kt * seg, d))
        vals.append(pooled[:, :, 1].reshape(h, n_kt * seg, d))
        cols = torch.arange(n_kt * seg, device=q.device)
        col_level.append(torch.full_like(cols, li))
        col_block.append(cols // seg)
        col_ok.append(cols < -(-length // level))
        col_val.append(torch.full(cols.shape, math.log(level), device=q.device))
    kall, vall = torch.cat(keys, dim=1)[None], torch.cat(vals, dim=1)[None]
    col_level, col_block = torch.cat(col_level), torch.cat(col_block)
    col_ok, col_val = torch.cat(col_ok), torch.cat(col_val).to(torch.bfloat16)
    level_mask = lists_to_level_masks(idx, cnt, n_kt)  # [1, H, n_q, 4, n_kt]
    ninf = torch.full((), float("-inf"), dtype=torch.bfloat16, device=q.device)

    def band(i):
        return torch.where(level_mask[:, :, i][..., col_level, col_block] & col_ok,
                           col_val, ninf)

    attn_mask = _token_mask(torch, (1, h, length, kall.shape[2]), q_rows, band, q.device)
    return lambda: _masked_sdpa(torch, q, kall, vall, attn_mask)


def _masked_sdpa(torch, q, k, v, attn_mask):
    """The library call of the block-sparse forward: one memory-efficient
    SDPA with the additive token mask (the one fused SDPA kernel that takes
    an arbitrary mask; the math fallback would hold the full score matrix)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)


def _dense_work(q, k, v):
    """(flops, input bytes) of dense attention over q, k, v."""
    bh, lq, lk = q.shape[0] * q.shape[1], q.shape[2], k.shape[2]
    return 2.0 * bh * lq * lk * (q.shape[3] + v.shape[3]), _nbytes(q, k, v)


def check_kernels(torch, dev, checks):
    """Phase 3: each forward kernel against its plain version at main-path
    shapes."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.kernels.block_sparse_attn import (
        block_sparse_attention, flash_attention, flash_attention_wide_v)
    from blade_torch.kernels.pack import _pack_kv_reference, pack_kv
    from blade_torch.kernels.ref_attention import (
        block_masked_attention, dense_attention_with_lse)
    from blade_torch.utils.rng import make_generator

    gen = make_generator(1234, dev)
    bf = torch.bfloat16
    h, d, L = 12, 128, 32760

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    # Tolerances: attention OUT_REL / LSE_ATOL; norm_rope 2e-2 + 1e-2|ref|
    # (one bf16 ulp of the rounded output); pack bit for bit.
    record = _recorder(checks)

    def attn_check(*a, **kw):
        _attn_check(torch, record, *a, **kw)

    dense_work = _dense_work

    sdpa = torch.nn.functional.scaled_dot_product_attention

    # -- dense flash (#1): predictor, pooled branch, dense leg ------------------
    cfg = C.derive_asa_config(C.WAN_480P)
    tokens, nk = cfg.sample_tokens_per_block, 256
    ls = nk * tokens
    qs, ks = randn(1, h, ls, d), randn(1, h, ls, d)
    pool = torch.nn.functional.one_hot(torch.arange(ls, device=dev) // tokens, 256).to(bf)
    pool = pool.expand(1, h, ls, 256).contiguous()
    attn_check("dense_fwd", "predictor q,k [1,12,4096,128] v [1,12,4096,256]",
               lambda: flash_attention_wide_v(qs, ks, pool),
               lambda: dense_attention_with_lse(qs, ks, pool), 20, 3, False,
               *dense_work(qs, ks, pool), library=lambda: sdpa(qs, ks, pool))
    q, k, v = randn(1, h, L, d), randn(1, h, L, d), randn(1, h, L, d)
    kp = (k.float().reshape(1, h, -1, 30, d).mean(3)).to(bf)
    vp = (v.float().reshape(1, h, -1, 30, d).mean(3)).to(bf)
    attn_check("dense_fwd", "pooled q [1,12,32760,128] k,v [1,12,1092,128]",
               lambda: flash_attention(q, kp, vp, bias=math.log(30.0)),
               lambda: dense_attention_with_lse(q, kp, vp, bias=math.log(30.0)),
               20, 3, True, *dense_work(q, kp, vp), library=lambda: sdpa(q, kp, vp))
    attn_check("dense_fwd", "dense leg q,k,v [1,12,32760,128]",
               lambda: flash_attention(q, k, v),
               lambda: dense_attention_with_lse(q, k, v), 3, 1, False, *dense_work(q, k, v),
               library=lambda: sdpa(q, k, v))

    # -- sparse rows (#2) with a mask from the real predictor -----------------
    mask = asa.compute_mask(q, k, cfg, generator=make_generator(7, dev))
    density = mask.float().mean().item()
    attn_mask = _additive_mask(torch, mask, L)
    attn_check("sparse_fwd", f"q,k,v [1,12,32760,128] density {density:.4f} "
               f"{_row_blocks(mask)}",
               lambda: block_sparse_attention(q, k, v, mask),
               lambda: block_masked_attention(q, k, v, mask, block_k=128), 10, 1, True,
               4.0 * d * _block_pairs(mask, L, L), _nbytes(q, k, v, mask),
               library=lambda: _masked_sdpa(torch, q, k, v, attn_mask))
    del attn_mask
    torch.cuda.empty_cache()

    # -- pack_kv (#3), bit exact; the library call is its plain torch.stack --
    kf, vf = randn(h, 32768, d), randn(h, 32768, d)
    got, want = pack_kv(kf, vf), _pack_kv_reference(kf, vf)
    stack = lambda: torch.stack([kf.view(h, 256, 128, d), vf.view(h, 256, 128, d)], dim=2)
    pack_ms, stack_ms = _cuda_ms_turns(torch, [lambda: pack_kv(kf, vf), stack], 50)
    record("pack_kv", "k,v [12,32768,128] -> [12,65536,128]", torch.equal(got, want),
           _max_err(got, want), pack_ms,
           _cuda_ms(torch, lambda: _pack_kv_reference(kf, vf), 50), "bit exact", True,
           0.0, _nbytes(kf, vf, got), stack_ms)

    # -- norm_rope (#4) -------------------------------------------------------
    _norm_rope_check(torch, record, gen, dev, h, (21, 30, 52), True)


def _norm_rope_check(torch, record, gen, dev, heads, grid, main):
    """norm_rope (#4) against its plain version at one Wan width: x
    ``[1, t*h*w, heads*128]`` bf16 and the rope tables of the latent grid
    ``(t, h, w)`` in the Gilbert token order, as the Wan DiT builds them.
    Tolerance 2e-2 + 1e-2 |ref| (one bf16 ulp of the rounded output)."""
    from blade_torch.attention.gilbert import gilbert_permutations
    from blade_torch.kernels.norm_rope import _norm_rope_reference, norm_rope_heads
    from blade_torch.models.layers import rope_3d_tables

    d, (t, hh, w) = 128, grid
    length, dim = t * hh * w, heads * d
    x = torch.randn((1, length, dim), generator=gen, device=dev).to(torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(dim, generator=gen, device=dev)
    cos, sin = rope_3d_tables(d, grid)
    perm = gilbert_permutations(w, hh, t)[0]
    cos = torch.from_numpy(cos[perm]).to(dev)
    sin = torch.from_numpy(sin[perm]).to(dev)
    got = norm_rope_heads(x, scale, cos, sin, heads)
    want = _norm_rope_reference(x, scale, cos, sin, heads, 1e-6)
    record("norm_rope", f"x [1,{length},{dim}] -> [1,{heads},{length},{d}]",
           _within(got, want, 2e-2, 1e-2), _max_err(got, want),
           _cuda_ms(torch, lambda: norm_rope_heads(x, scale, cos, sin, heads), 50),
           _cuda_ms(torch, lambda: _norm_rope_reference(x, scale, cos, sin, heads, 1e-6), 20),
           "2e-2+1e-2|ref|", main, 0.0, _nbytes(x, scale, cos, sin, got))


def _requests(torch, pipe, text, seed, steps, frames_shape, n=2):
    """``n`` requests through ``T2VPipeline.generate`` with the kernels' launch
    counters zeroed just before and read just after; per request the host
    times of the whole clip, the denoise and the decode, and peak memory
    over the request and over its denoise and its decode apart."""
    from blade_torch.kernels._build import KERNELS, reset_launch_counts
    from blade_torch.utils.rng import make_generator

    dev = pipe.device
    # Measurement shim: time the two halves of generate() on the host clock.
    timed = {}
    sample_latents, decode_latents = pipe.sample_latents, pipe.decode_latents

    def timed_half(name, fn):
        def run(*a, **kw):
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timed[f"{name}_s"] = time.perf_counter() - t
            timed[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            timed[name] = out
            return out

        return run

    pipe.sample_latents = timed_half("denoise", sample_latents)
    pipe.decode_latents = timed_half("decode", decode_latents)
    results = []
    reset_launch_counts()
    try:
        for i in range(n):
            t = time.perf_counter()
            frames = pipe.generate(text, generator=make_generator(seed + i, dev), num_steps=steps)
            u8 = pipe.frames_to_uint8(frames)
            torch.cuda.synchronize()
            clip_s = time.perf_counter() - t
            assert u8.shape == frames_shape and u8.dtype == torch.uint8, u8.shape
            assert torch.isfinite(timed["denoise"]).all(), "non-finite latents"
            assert torch.isfinite(frames).all()
            r = dict(request=i, denoise_s=timed["denoise_s"],
                     step_ms=1000 * timed["denoise_s"] / steps,
                     decode_s=timed["decode_s"], clip_s=clip_s,
                     peak_mem_gib=max(timed["denoise_peak_gib"], timed["decode_peak_gib"],
                                      torch.cuda.max_memory_allocated() / 2**30),
                     denoise_peak_gib=timed["denoise_peak_gib"],
                     decode_peak_gib=timed["decode_peak_gib"],
                     frames_mean=float(u8.float().mean()), frames_std=float(u8.float().std()))
            print("request " + json.dumps(r))
            results.append(r)
    finally:
        del pipe.sample_latents, pipe.decode_latents  # back to the class's methods
    launches = {name: k.launches for name, k in KERNELS.items()}
    print(f"launches over the {n} request(s) " + json.dumps(launches))
    return results, launches, timed["denoise"]


def serve(torch, dev):
    """Phase 4: two full 480p requests on the port's Wan path."""
    from blade_torch.cli.inference import build_pipeline, get_args, random_text_embeds
    from blade_torch.models.wan_dit import WanModel

    args = get_args(["--preset", "wan-1.3b-480p", "--random-init", "--seed", "8888",
                     "--steps", "8"])
    t0 = time.perf_counter()
    pipe = build_pipeline(args)
    torch.cuda.synchronize()
    print(f"pipeline built (random weights, seed 0) in {time.perf_counter() - t0:.2f} s; "
          f"DiT params {sum(p.numel() for p in pipe.dit.parameters()) / 1e9:.3f} B")
    text = random_text_embeds(pipe, "a corgi surfing a wave at sunset")
    assert text.shape == (1, 512, 4096)
    results, launches, lat = _requests(torch, pipe, text, args.seed, args.steps,
                                       (1, 81, 480, 832, 3))
    L, steps = pipe.preset.dit.num_layers, args.steps
    # the text cross-attention packs q, k and v and unpacks its output a layer
    per_clip = {"norm_rope": 2 * L * steps, "sparse_fwd": L * steps, "pack_kv": L * steps,
                "heads_pack": 3 * L * steps, "heads_unpack": L * steps,
                **_glue_launches(L, steps)}
    for name, n in per_clip.items():
        assert launches[name] == 2 * n, (name, launches[name], 2 * n)
    assert launches["dense_fwd"] >= 2 * 3 * L * steps, launches
    # serving runs no backward kernel and none of the multilevel lane's
    assert all(launches[n] > 0 for n in SERVE_KERNELS), launches
    assert all(launches[n] == 0 for n in BACKWARD_KERNELS + ("attn_delta",)), launches
    assert launches["multilevel_fwd"] == launches["pack_kv_pyramid"] == 0, launches

    # One dense forward on the same weights for comparison.
    dense = WanModel(pipe.preset.dit, dtype=pipe.dtype, device=dev).eval()
    dense.load_state_dict(pipe.dit.state_dict())
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


def _small_asa_models(torch, dev, seed, **asa_fields):
    """The small ASA model of phases 5, 7 and 16 (2 layers of width 256, 2
    heads of 128, 960 tokens in 8 blocks) twice on shared random weights:
    bf16 activations on the card, f32 on the CPU; both frozen.
    ``asa_fields`` override the ASA config (phase 16: the "max" predictor)."""
    from blade_torch.attention.asa import ASAConfig
    from blade_torch.attention.integration import asa_model_kwargs
    from blade_torch.models.wan_dit import WanConfig, WanModel
    from blade_torch.utils.rng import make_generator

    cfg = WanConfig(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32)
    asa = ASAConfig(latent_width=16, latent_height=15, latent_frames=4, sample_gap=30,
                    min_retain_ratio=0.05, max_retain_ratio=0.5, **asa_fields)
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


# Backward tolerance: each gradient's max |err| <= 2e-2 * max |ref|.  The
# kernels round p and ds to bf16 before each product (2^-9 relative a term,
# as the TPU kernels feed the MXU) and the gradients to bf16 on output; the
# plain backward is f32 throughout.
BWD_REL = 2e-2


def _dense_bwd_library(torch, q, k, v, g_out, scale):
    """The library calls of the dense backward, each computing dQ, dK and dV
    in one call, so that its time stands against #5 + #6 and delta: the
    flash-attention backward op on the saved outputs of its forward and,
    where the cuDNN backend runs on this card, the cuDNN backward.  Neither
    takes an LSE cotangent (SDPA returns no LSE).  A constant score bias
    (the pooled branch's +log gap) leaves P unchanged, so the calls run
    unbiased on the same q, k, v.  Forwards run here, outside any timed
    region.  Returns ``{name: call}``."""
    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, offset = aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, False, False, scale=scale)[:8]
    calls = {"flash": lambda: aten._scaled_dot_product_flash_attention_backward(
        g_out, q, k, v, out, lse, cq, ck, mq, mk, 0.0, False, seed, offset, scale=scale)}
    try:
        c_out, c_lse, c_cq, c_ck, c_mq, c_mk, c_seed, c_off = \
            aten._scaled_dot_product_cudnn_attention(q, k, v, None, True, 0.0, False, False,
                                                     scale=scale)[:8]

        def cudnn():
            return aten._scaled_dot_product_cudnn_attention_backward(
                g_out, q, k, v, c_out, c_lse, c_seed, c_off, None, c_cq, c_ck, c_mq, c_mk,
                0.0, False, scale=scale)

        cudnn()
        torch.cuda.synchronize()
        calls["cudnn"] = cudnn
    except RuntimeError as e:
        print(f"cuDNN attention backward not timed on this card: {str(e).splitlines()[0]}")
    return calls


def _efficient_bwd_library(torch, q, k, v, g_out, attn_mask, scale, out=None, lse=None):
    """The library call of a masked backward: one memory-efficient SDPA
    backward with the additive token mask ``attn_mask`` (dQ, dK and dV in
    one call, no LSE cotangent), on the saved outputs of its forward; with
    ``out`` and ``lse`` given (a pooled level of the fused lane), on those
    instead, so that p comes from the merged LSE as in the kernels."""
    aten = torch.ops.aten
    o, l, seed, offset = aten._scaled_dot_product_efficient_attention(
        q, k, v, attn_mask, True, 0.0, False, scale=scale)
    if out is not None:
        o = out
        l[..., :lse.shape[-1]] = lse
    return {"efficient": lambda: aten._scaled_dot_product_efficient_attention_backward(
        g_out, q, k, v, attn_mask, o, l, seed, offset, 0.0, [True, True, True, False],
        False, scale=scale)}


def _time_with_library(torch, fns, library, reps):
    """Times of ``fns`` and of the fastest call of ``library`` (``{name:
    call}`` or None), all in turns (A B B A): ``(times, library_ms, name)``."""
    if not library:
        return [_cuda_ms(torch, fn, reps) for fn in fns], None, None
    names = list(library)
    times = _cuda_ms_turns(torch, list(fns) + [library[n] for n in names], reps)
    lib = dict(zip(names, times[len(fns):]))
    best = min(lib, key=lib.get)
    if len(lib) > 1:
        print("library backward calls: " + ", ".join(f"{n} {t:.4f} ms" for n, t in lib.items()))
    return times[:len(fns)], lib[best], best


def _delta_check(torch, record, bsa, shape, out, g_out, reps, main):
    """``attention_delta`` (``bt_attn_delta``) against its plain version on
    one backward's ``out`` and ``g_out``; returns ``delta``.  A package
    without the kernel (an older checkout timed through
    ``scripts/torch_kernel_times.py``) gets the torch expression, timed and
    printed, and no check."""
    def plain():
        return (g_out.float() * out.float()).sum(dim=-1)

    plain_ms = _cuda_ms(torch, plain, reps)
    fn = getattr(bsa, "attention_delta", None)
    if fn is None:
        print(f"delta = rowsum(dO * O) in torch, {shape}: {plain_ms:.4f} ms a backward")
        return plain()
    got, want = fn(out, g_out), plain()
    tol = 1e-5 * (out.float() * g_out.float()).abs().sum(-1)
    record("attn_delta", f"out,dO {shape}", bool(((got - want).abs() <= tol).all()),
           _max_err(got, want), _cuda_ms(torch, lambda: fn(out, g_out), reps), plain_ms,
           f"1e-5*sum|dO*O| a row (smallest {tol.min().item():.2e}; f32 sums in another "
           "order)", main, 2.0 * out.numel(), _nbytes(out, g_out, got))
    return got


def _bwd_check(torch, record, gen, kind, shape, q, k, v, mask, bias, reps, main=False,
               library=None):
    """The dQ and the dK/dV kernels of dense (``mask=None``) or 128-row
    sparse attention against the plain backward, with random ``g_out`` and
    a non-zero ``g_lse``; a mask's empty rows and the key blocks no row
    selected must get no gradient.  ``library(g_out)`` gives the library
    calls (``{name: call}``), timed in turns with both kernels; the fastest
    stands on both rows, against the pair.  Delta is checked and timed apart
    (``_delta_check``); the sparse backward is also timed whole, as the port
    runs it (delta, the lists and transposed lists, both kernels)."""
    from blade_torch.kernels import block_sparse_attn as bsa
    from blade_torch.kernels.block_sparse_attn import _backward_cuda, block_sparse_attention
    from blade_torch.kernels.ref_attention import attention_backward_reference

    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    with torch.no_grad():
        out, lse = block_sparse_attention(q, k, v, mask, bias=bias)
    g_out = torch.randn(q.shape, generator=gen, device=q.device).to(torch.bfloat16)
    g_lse = torch.randn(lse.shape, generator=gen, device=q.device)
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
        flat = mask.reshape(-1, *mask.shape[-2:])
        empty = (~flat.any(-1)).nonzero()
        assert empty.numel(), "the forced empty row is missing"
        for bh, qb in empty.tolist():
            rows = got["dq"].reshape(-1, q.shape[2], d)[bh, qb * 128:(qb + 1) * 128]
            assert rows.float().abs().max().item() == 0.0, "empty row has a gradient"
        unselected = (~flat.any(-2)).nonzero()
        assert unselected.numel(), "the forced unselected key block is missing"
        for bh, kb in unselected.tolist():
            for name in ("dk", "dv"):
                keys = got[name].reshape(-1, k.shape[2], d)[bh, kb * 128:(kb + 1) * 128]
                assert keys.float().abs().max().item() == 0.0, f"unselected block has {name}"
    plain_ms = _cuda_ms(torch, plain, 1)
    lq, lk = q.shape[2], k.shape[2]
    pairs = (q.shape[0] * q.shape[1] * float(lq) * lk if mask is None
             else _block_pairs(mask, lq, lk))
    stats = _nbytes(q, k, v, g_out, lse, g_lse) + 4 * lse.numel()  # + delta
    # dQ: S, dP, dQ products; dK/dV: S, dP, dV, dK (2 flops a multiply-add)
    work = {"dq": (6.0 * d * pairs, stats + _nbytes(got["dq"])),
            "dkv": (8.0 * d * pairs, stats + _nbytes(got["dk"], got["dv"]))}
    # Each kernel timed on its own: delta = rowsum(dO * O) (once a backward,
    # shared by both kernels) is computed here and timed apart.
    delta = _delta_check(torch, record, bsa, f"[{','.join(map(str, q.shape))}]", out, g_out,
                         reps, main)
    # The sparse kernels timed on lists built once (an older package builds
    # them, and packs K/V for dQ, inside each call).
    kw = {"delta": delta}
    if mask is not None and hasattr(bsa, "backward_lists"):
        kw["lists"] = bsa.backward_lists(mask.reshape(-1, *mask.shape[-2:]))
    parts = (("dq", ("dq",)), ("dkv", ("dk", "dv")))
    times, lib_ms, lib_name = _time_with_library(
        torch, [lambda part=part: _backward_cuda(*args, parts=(part,), **kw)
                for part, _ in parts],
        library(g_out) if library else None, reps)
    if mask is not None:
        m = mask.reshape(-1, *mask.shape[-2:])
        steps = {"whole": lambda: _backward_cuda(*args),
                 "lists": lambda: bsa.mask_to_block_lists(m),
                 "transposed lists": lambda: bsa.mask_to_block_lists(m.transpose(-1, -2))}
        print(f"sparse backward as the port runs it, {shape}: " + ", ".join(
            f"{n} {_cuda_ms(torch, fn, reps):.4f} ms" for n, fn in steps.items()) +
            "; delta, dq and dkv as recorded")
    for (part, names), ms in zip(parts, times):
        errs = {n: _max_err(got[n], want[n]) for n in names}
        refs = {n: want[n].float().abs().max().item() for n in names}
        per = ", ".join(f"{n} {errs[n]:.2e}/{refs[n]:.2e}" for n in names)
        record(f"{kind}_{part}", shape, all(errs[n] <= BWD_REL * refs[n] for n in names),
               max(errs.values()), ms, plain_ms,
               f"2e-2*max|ref| per grad (err/max|ref|: {per}; plain = the whole "
               "backward)", main, *work[part], library_ms=lib_ms,
               library_call=lib_name and f"{lib_name} backward: dq+dk+dv")


def check_backward(torch, dev, checks):
    """Phase 6: the four backward kernels and delta against their plain
    versions at main-path shapes, with random ``g_out`` and a non-zero
    ``g_lse``."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.utils.rng import make_generator

    gen = make_generator(4321, dev)
    h, d, L = 12, 128, 32760
    record = _recorder(checks)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = randn(1, h, L, d), randn(1, h, L, d), randn(1, h, L, d)
    kp = (k.float().reshape(1, h, -1, 30, d).mean(3)).to(torch.bfloat16)
    vp = (v.float().reshape(1, h, -1, 30, d).mean(3)).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    _bwd_check(torch, record, gen, "dense", "pooled q,dO [1,12,32760,128] k,v [1,12,1092,128]",
               q, kp, vp, None, math.log(30.0), reps=10, main=True,
               library=lambda g: _dense_bwd_library(torch, q, kp, vp, g, scale))
    _bwd_check(torch, record, gen, "dense", "dense leg q,k,v,dO [1,12,32760,128]", q, k, v,
               None, 0.0, reps=2,
               library=lambda g: _dense_bwd_library(torch, q, k, v, g, scale))
    cfg = C.derive_asa_config(C.WAN_480P)
    mask = asa.compute_mask(q, k, cfg, generator=make_generator(17, dev))
    mask[0, 5, 100] = False  # one forced empty row
    mask[0, 6, :, 40] = False  # one key block that no row selected
    attn_mask = _additive_mask(torch, mask, L)
    _bwd_check(torch, record, gen, "sparse", f"q,k,v,dO [1,12,32760,128] density "
               f"{mask.float().mean().item():.4f}", q, k, v, mask, 0.0, reps=5, main=True,
               library=lambda g: _efficient_bwd_library(torch, q, k, v, g, attn_mask, scale))
    del attn_mask
    torch.cuda.empty_cache()


def _lora_grads(torch, model, lora, inputs, cot, device, **attn_kwargs):
    """LoRA gradients of ``sum(v * cot)`` through ``model`` on ``device``,
    the velocity ``v`` and the mask artifact (when ``collect_mask`` is
    set)."""
    from blade_torch.training.lora import merge_lora

    base = {n: p.detach() for n, p in model.named_parameters()}
    leaves = {k: v.to(device).requires_grad_(True) for k, v in lora.items()}
    out = torch.func.functional_call(
        model, merge_lora(base, leaves, alpha=4.0, rank=4),
        tuple(x.to(device) for x in inputs), {"attn_kwargs": attn_kwargs})
    vel, masks = out if isinstance(out, tuple) else (out, None)
    grads = torch.autograd.grad((vel.float() * cot.to(device)).sum(), list(leaves.values()))
    return {k: gr.float().cpu() for k, gr in zip(leaves, grads)}, vel.detach(), masks


def _test_lora(torch, model, g, seed):
    """Rank-4 factors over ``model``'s targets, ``a`` from ``seed``, ``b``
    from the CPU generator ``g`` (init_lora's are zero) so every factor has
    a gradient."""
    from blade_torch.training.lora import init_lora
    from blade_torch.utils.rng import make_generator

    base = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return {k: (v if k.endswith(".a") else 0.05 * torch.randn(v.shape, generator=g))
            for k, v in init_lora(make_generator(seed), base, rank=4).items()}


def gradient_check(torch, dev):
    """Phase 7: the training twin of phase 5.  LoRA gradients of one loss
    through the small ASA model, kernels (bf16, card) against plain
    versions (f32, CPU), with shared weights and adapters and the card's
    masks replayed."""
    from blade_torch.utils.rng import make_generator

    card, cpu = _small_asa_models(torch, dev, 21)
    g = torch.Generator().manual_seed(22)
    lora = _test_lora(torch, cpu, g, 23)
    x = torch.randn(1, 16, 4, 30, 32, generator=g)
    text = torch.randn(1, 8, 64, generator=g)
    cot = torch.randn(1, 16, 4, 30, 32, generator=g)
    inputs = (x, torch.tensor([700.0]), text)
    got, _, masks = _lora_grads(torch, card, lora, inputs, cot, dev,
                                generator=make_generator(24, dev), collect_mask=True)
    want, _, _ = _lora_grads(torch, cpu, lora, inputs, cot, torch.device("cpu"),
                             masks=masks.cpu())
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
    args = cli.get_args(argv + ["--output_dir", "unused"])
    fwd = _tdm_forwards(args.k_step, args.cfg, args.lambda_reg) * layers
    for i, counts in enumerate(per_step):
        print(f"train step {i} launches " + json.dumps(counts))
        # the fake and the generator backward: the sparse pair once a layer,
        # the dense pair twice (the pooled branch and the text cross-attention)
        for name in BACKWARD_KERNELS:
            want = (4 if name.startswith("dense") else 2) * layers
            assert counts[name] == want, (i, name, counts[name], want)
        # delta once a backward pass (sparse and pooled branch, cross-attention)
        # of each layer; only the forwards pack (the sparse backward reads K/V
        # in place)
        assert counts["attn_delta"] == 6 * layers, (i, counts["attn_delta"])
        assert counts["pack_kv"] == fwd, (i, counts["pack_kv"], fwd)
        # the cross-attention's relayouts: q, k, v packed and the output
        # unpacked a forward; each one's gradient is the other in a backward
        assert counts["heads_pack"] == 3 * fwd + 2 * layers, (i, counts["heads_pack"])
        assert counts["heads_unpack"] == fwd + 6 * layers, (i, counts["heads_unpack"])
        assert all(counts[n] > 0 for n in SERVE_KERNELS), (i, counts)
        # the block glue's kernels in the no-grad forwards alone: the two
        # gradient forwards (and remat's recomputation) take the expression
        for name, n in _glue_launches(layers, fwd // layers - 4).items():
            assert counts[name] == n, (i, name, counts[name], n)
    # the adapters moved (b starts at zero); the frozen base is bit-unchanged
    moved_g = sum(state.lora_g[k].abs().sum().item() for k in state.lora_g if k.endswith(".b"))
    moved_f = sum(state.lora_f[k].abs().sum().item() for k in state.lora_f if k.endswith(".b"))
    assert moved_g > 0, "lora_g did not move"
    if all(r["fake_skipped"] for r in history):
        print("lora_f: every fake update was skipped by the loss guard")
    else:
        assert moved_f > 0, "lora_f did not move"
    fresh = cli.build_model(args, cli.build_preset(args), dev)
    assert all(torch.equal(p, state.base[n]) for n, p in fresh.named_parameters()), \
        "the frozen base changed"
    del fresh
    warm = [r["step_s"] for r in history[1:]]
    res = dict(s_per_step_warm=sum(warm) / len(warm), step_s=[r["step_s"] for r in history],
               loss_fake=[r["loss_fake"] for r in history],
               loss_du=[r["loss_du"] for r in history],
               forwards_a_step=fwd // layers,
               fake_skipped=[r["fake_skipped"] for r in history],
               peak_mem_gib=peak / 2**30, lora_g_b_abs_sum=moved_g,
               lora_f_b_abs_sum=moved_f)
    print("train " + json.dumps(res))
    launches = {name: sum(c[name] for c in per_step) for name in KERNELS}
    return res, launches


def check_cog_multilevel(torch, dev, checks):
    """Phase 9, first half: the multi-level kernel and the pyramid pack
    against their plain versions at CogVideoX-5B 480p shapes and at Wan 480p
    shapes, with lists from the real predictor."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.kernels.multilevel_attn import multilevel_from_records
    from blade_torch.kernels.pack import _pack_kv_pyramid_reference, pack_kv_pyramid
    from blade_torch.kernels.ref_attention import multilevel_lists_attention
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2024, dev)
    record = _recorder(checks)
    cfg, dit = C.derive_asa_config(C.COGVIDEOX_480P), C.COGVIDEOX_480P.dit
    assert (dit.num_heads, dit.head_dim, cfg.seq_len, cfg.sample_tokens_per_block) == (
        COG_HEADS, COG_HEAD_DIM, COG_TOKENS, COG_SAMPLE)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def multilevel(preset, main):
        cfg = C.derive_asa_config(preset, "multilevel")
        h, d = preset.dit.num_heads, preset.dit.head_dim
        length = cfg.seq_len
        q, k, v = (randn(1, h, length, d) for _ in range(3))
        idx, cnt = asa.compute_lists(q, k, cfg, generator=make_generator(9, dev))
        kf, vf = k.reshape(h, length, d), v.reshape(h, length, d)
        records = pack_kv_pyramid(kf, vf)
        want = _pack_kv_pyramid_reference(kf, vf)
        record("pack_kv_pyramid", f"k,v [{h},{length},{d}] -> levels 1,2,4,8",
               all(torch.equal(a, b) for a, b in zip(records, want)),
               max(_max_err(a, b) for a, b in zip(records, want)),
               _cuda_ms(torch, lambda: pack_kv_pyramid(kf, vf), 20),
               _cuda_ms(torch, lambda: _pack_kv_pyramid_reference(kf, vf), 5), "bit exact",
               main, 0.0, _nbytes(kf, vf, *records))
        q_rows, scale = cfg.multilevel_q_rows, 1.0 / math.sqrt(d)
        pairs = _multilevel_pairs(idx, cnt, length, length, q_rows)
        library = _multilevel_library(torch, q, records, idx, cnt, length, q_rows)
        _attn_check(torch, record, "multilevel_fwd",
                    f"q [1,{h},{length},{d}] q_rows {q_rows} key share "
                    f"{pairs / (h * float(length) ** 2):.4f}",
                    lambda: multilevel_from_records(q, records, idx, cnt, length, q_rows,
                                                    scale),
                    lambda: multilevel_lists_attention(q, k, v, (idx, cnt), q_rows=q_rows,
                                                       scale=scale),
                    10, 1, main, 4.0 * d * pairs, _nbytes(q, *records, idx, cnt),
                    library=library)
        del library
        torch.cuda.empty_cache()
        print(f"multilevel lists {preset.name}: cap {idx.shape[-1]}, mean counts per level "
              f"{[round(float(c), 2) for c in cnt.float().mean(dim=(0, 1, 2))]}")

    multilevel(C.COGVIDEOX_480P, True)
    multilevel(C.WAN_480P, False)


def check_dense_d64(torch, dev, checks):
    """Phase 9, second half: the dense kernel at d = 64 against its plain
    version at the CogVideoX-5B 480p predictor (V width 256) and dense-leg
    shapes; the library call is one SDPA on the same inputs."""
    from blade_torch.kernels.block_sparse_attn import flash_attention, flash_attention_wide_v
    from blade_torch.kernels.ref_attention import dense_attention_with_lse
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2025, dev)
    record = _recorder(checks)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, d, length, tokens = COG_HEADS, COG_HEAD_DIM, COG_TOKENS, COG_SAMPLE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    ls = -(-length // 128) * tokens
    qs, ks = randn(1, h, ls, d), randn(1, h, ls, d)
    pool = torch.nn.functional.one_hot(torch.arange(ls, device=dev) // tokens, 256)
    pool = pool.to(torch.bfloat16).expand(1, h, ls, 256).contiguous()
    _attn_check(torch, record, "dense_fwd",
                f"cog predictor q,k [1,{h},{ls},{d}] v [1,{h},{ls},256]",
                lambda: flash_attention_wide_v(qs, ks, pool),
                lambda: dense_attention_with_lse(qs, ks, pool), 20, 3, False,
                *_dense_work(qs, ks, pool), library=lambda: sdpa(qs, ks, pool))
    q, k, v = (randn(1, h, length, d) for _ in range(3))
    _attn_check(torch, record, "dense_fwd", f"cog dense leg q,k,v [1,{h},{length},{d}]",
                lambda: flash_attention(q, k, v), lambda: dense_attention_with_lse(q, k, v),
                3, 1, False, *_dense_work(q, k, v), library=lambda: sdpa(q, k, v))


def check_cog_qk(torch, dev, checks):
    """Phase 9, third part: CogVideoX's q/k lane (per-head LayerNorm, video
    RoPE and head split for q and k in one launch) and its input gradient
    against their plain versions at CogVideoX-5B 480p, [1, 17776, 3072] with
    226 text rows last (ASA's order), each timed in turns with the plain
    version (A B B A); then the whole of ``dit.qkv`` outside its GEMMs, the
    lane plus v's head split (``heads_pack``), in turns with the composition
    it replaced (the plain lane plus ``.transpose(1, 2).contiguous()``)."""
    from blade_torch.kernels.norm_rope import heads_pack
    from blade_torch.kernels.qk_norm_rope import (
        _qk_dx_cuda, _qk_norm_rope_reference, qk_norm_rope)
    from blade_torch.models.layers import apply_rope_half
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2029, dev)
    record = _recorder(checks)
    h, d, length, n_txt = COG_HEADS, COG_HEAD_DIM, COG_TOKENS, 226
    n_vid, dim = length - n_txt, COG_HEADS * COG_HEAD_DIM

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q_proj, k_proj, v_proj = (randn(1, length, dim) for _ in range(3))
    params = [1.0 + 0.2 * torch.randn(d, generator=gen, device=dev),
              0.1 * torch.randn(d, generator=gen, device=dev),
              1.0 + 0.2 * torch.randn(d, generator=gen, device=dev),
              0.1 * torch.randn(d, generator=gen, device=dev)]
    ang = torch.rand((n_vid, d // 2), generator=gen, device=dev) * 6.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    lane = (*params, cos, sin, h, 0, n_vid)

    def kernel():
        return qk_norm_rope(q_proj, k_proj, *lane)

    def plain():
        return _qk_norm_rope_reference(q_proj, k_proj, *lane, 1e-6)

    # Tolerance: one bf16 ulp at each head row's largest value (the
    # LayerNorm's sums in another order can turn one rounding), read on a
    # call with no video rows; the rotation after it bit for bit.
    def within_ulp(got, want):
        rows = torch.maximum(got.float().abs(), want.float().abs()).reshape(-1, d).amax(-1)
        ulp = torch.exp2(torch.floor(torch.log2(rows.clamp_min(2.0 ** -100))) - 7)
        return bool(((got.float() - want.float()).abs().reshape(-1, d) <= ulp[:, None]).all())

    got = kernel()
    normed = qk_norm_rope(q_proj, k_proj, *params, cos[:0], sin[:0], h, 0, 0)
    want = _qk_norm_rope_reference(q_proj, k_proj, *params, cos[:0], sin[:0], h, 0, 0, 1e-6)
    ok = all(within_ulp(n, w) and torch.equal(g[:, :, n_vid:], n[:, :, n_vid:])
             and torch.equal(g[:, :, :n_vid], apply_rope_half(n[:, :, :n_vid], cos, sin))
             for g, n, w in zip(got, normed, want))
    err = max(_max_err(g, w) for g, w in zip(got, plain()))
    ms, plain_ms = _cuda_ms_turns(torch, [kernel, plain], 20)
    record("qk_norm_rope", f"q,k [1,{length},{dim}] -> [1,{h},{length},{d}] x2, {n_txt} text last",
           ok, err, ms, plain_ms, "LayerNorm 1 bf16 ulp of the head row's max, RoPE exact", True,
           0.0, _nbytes(q_proj, k_proj, *got, cos, sin))
    del got, want, normed

    g_q, g_k = randn(1, h, length, d), randn(1, h, length, d)
    leaves = [q_proj.detach().requires_grad_(True), k_proj.detach().requires_grad_(True)]
    plain_out = _qk_norm_rope_reference(*leaves, *lane, 1e-6)

    def dx_kernel():
        return _qk_dx_cuda(g_q, g_k, q_proj, k_proj, params[0], params[2], cos, sin, h, 0,
                           n_vid, 1e-6)

    def dx_plain():
        return torch.autograd.grad(plain_out, leaves, (g_q, g_k), retain_graph=True)

    got, want = dx_kernel(), dx_plain()
    ok = all(within_ulp(g, w) for g, w in zip(got, want))
    err = max(_max_err(g, w) for g, w in zip(got, want))
    ms, plain_ms = _cuda_ms_turns(torch, [dx_kernel, dx_plain], 20)
    record("qk_norm_rope_dx", f"g [1,{h},{length},{d}], q,k [1,{length},{dim}] -> dq,dk x2",
           ok, err, ms, plain_ms, "1 bf16 ulp of the head row's max", True, 0.0,
           _nbytes(g_q, g_k, q_proj, k_proj, *got, cos, sin))
    del got, want, plain_out, leaves

    def glue_now():
        return kernel(), heads_pack(v_proj, h)

    def glue_before():
        return plain(), v_proj.view(1, length, h, d).transpose(1, 2).contiguous()

    now_ms, before_ms = _cuda_ms_turns(torch, [glue_now, glue_before], 20)
    bound_ms, _ = _bound(0.0, 3 * _nbytes(q_proj) * 2)
    print(f"cog dit.qkv outside its GEMMs (q/k lane + v head split), in turns: "
          f"{now_ms:.4f} ms (qk_norm_rope + heads_pack) vs {before_ms:.4f} ms (the plain "
          f"composition + a strided copy); bound {bound_ms:.4f} ms")


def serve_cog(torch, dev):
    """Phase 10: two full-width, full-depth CogVideoX-5B 480p requests on the
    multilevel lane, then one forward with dense attention."""
    from blade_torch.cli.inference import build_pipeline, get_args, random_text_embeds
    from blade_torch.models.layers import dense_attention_fn

    args = get_args(["--preset", "cogvideox-5b-480p", "--random-init", "--seed", "8888",
                     "--steps", "8"])
    t0 = time.perf_counter()
    pipe = build_pipeline(args)
    torch.cuda.synchronize()
    print(f"cogvideox pipeline built (random weights, seed 0, lane {pipe.mask_mode}) in "
          f"{time.perf_counter() - t0:.2f} s; DiT params "
          f"{sum(p.numel() for p in pipe.dit.parameters()) / 1e9:.3f} B")
    assert pipe.mask_mode == "multilevel" and pipe.preset.dit.num_layers == 42
    text = random_text_embeds(pipe, "a corgi surfing a wave at sunset")
    assert text.shape == (1, 226, 4096)
    results, launches, lat = _requests(torch, pipe, text, args.seed, args.steps,
                                       (1, 49, 480, 720, 3))
    n = 2 * pipe.preset.dit.num_layers * args.steps
    for name, count in launches.items():
        want = n if name in COG_KERNELS else 0
        assert count == want, (name, count, want)

    # One forward of the same model and weights with dense flash attention.
    sparse_fn, pipe.dit.attention_fn = pipe.dit.attention_fn, dense_attention_fn
    tstep = torch.full((1,), 999.0, device=dev)
    try:
        with torch.inference_mode():
            pipe.dit(lat, tstep, text)
            torch.cuda.synchronize()
            t = time.perf_counter()
            v = pipe.dit(lat, tstep, text)
            torch.cuda.synchronize()
            dense_ms = 1000 * (time.perf_counter() - t)
    finally:
        pipe.dit.attention_fn = sparse_fn
    assert torch.isfinite(v).all()
    print(f"cogvideox dense-attention forward {dense_ms:.1f} ms; multilevel step "
          f"{results[1]['step_ms']:.1f} ms (warm request)")
    return results, launches, dense_ms


def cog_reference_check(torch, dev):
    """Phase 11: the CogVideoX model with kernels (bf16, card) against its
    plain versions (f32, CPU) on a small input: 1024 video + 16 text tokens
    (9 key blocks, 5 mask rows of 256), shared weights, the card's lists
    replayed on the CPU."""
    from blade_torch.attention.asa import ASAConfig
    from blade_torch.attention.integration import asa_model_kwargs
    from blade_torch.models.cogvideox_dit import COGVIDEOX_TINY, CogVideoXModel
    from blade_torch.utils.rng import make_generator

    asa_cfg = ASAConfig(latent_width=16, latent_height=16, latent_frames=4, text_length=16,
                        mask_mode="multilevel", multilevel_q_rows=256)
    card = CogVideoXModel(COGVIDEOX_TINY, dtype=torch.bfloat16, device=dev,
                          **asa_model_kwargs(asa_cfg)).eval()
    card.random_init_(make_generator(31, dev))
    cpu = CogVideoXModel(COGVIDEOX_TINY, dtype=torch.float32, **asa_model_kwargs(asa_cfg))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    g = torch.Generator().manual_seed(32)
    x = torch.randn(1, 4, 16, 32, 32, generator=g)
    text = torch.randn(1, 16, 64, generator=g)
    t = torch.tensor([700.0])
    with torch.inference_mode():
        v_card, (idx, cnt) = card(x.to(dev), t.to(dev), text.to(dev),
                                  attn_kwargs={"generator": make_generator(33, dev),
                                               "collect_mask": True})
        v_cpu = cpu(x, t, text, attn_kwargs={"masks": (idx.cpu(), cnt.cpu())})
    err = (v_card.float().cpu() - v_cpu).abs().max().item()
    scale = v_cpu.abs().max().item()
    counts = cnt.float().mean(dim=(0, 1, 2, 3)).tolist()
    print(f"cogvideox reference check: v max_abs_err {err:.4e} (bf16 kernels on the card vs "
          f"f32 plain on the CPU, |ref| max {scale:.3f}, mean list counts per level "
          f"{[round(c, 2) for c in counts]}, tol 5e-2*|ref|max)")
    assert torch.isfinite(v_card).all() and idx.shape == (2, 1, 2, 5, 4, 128)
    assert all(c > 0 for c in counts), counts
    assert err <= 5e-2 * scale, (err, scale)
    return err


def check_wan14b_predictor(torch, dev, checks):
    """Phase 12, first checks: the dense kernel as the Wan2.1-14B 720p "sum"
    predictor (16 sampled tokens of each of 591 key blocks, V the one-hot
    block pooling lane-padded to 640 columns: three Q K^T passes), timed on
    all 40 heads, its plain version on the first 4, the library call one
    SDPA on the same inputs; then ``pack_kv`` at the 14B K/V width (591
    whole blocks, as phase 3 takes 256, so that ``torch.stack`` of the
    blocks is the library call); then ``norm_rope`` at the 14B q/k width
    (x [1,75600,5120], 40 heads of 128, the 21 x 45 x 80 grid's tables)."""
    from blade_torch import config as C
    from blade_torch.kernels.block_sparse_attn import flash_attention_wide_v
    from blade_torch.kernels.pack import _pack_kv_reference, pack_kv
    from blade_torch.kernels.ref_attention import dense_attention_with_lse
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2032, dev)
    record = _recorder(checks)
    cfg, dit = C.derive_asa_config(C.WAN_14B_720P, "multilevel"), C.WAN_14B_720P.dit
    h, d, tokens = dit.num_heads, dit.head_dim, cfg.sample_tokens_per_block
    n_k = -(-cfg.seq_len // 128)
    ls, width = n_k * tokens, -(-n_k // 128) * 128
    assert (h, d, ls, width) == (40, 128, 9456, 640)
    qs, ks = (torch.randn((1, h, ls, d), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    pool = torch.nn.functional.one_hot(torch.arange(ls, device=dev) // tokens, width)
    pool = pool.to(torch.bfloat16).expand(1, h, ls, width).contiguous()
    sub = 4
    _attn_check(torch, record, "dense_fwd",
                f"14b predictor q,k [1,{h},{ls},{d}] v [1,{h},{ls},{width}] (plain: {sub} heads)",
                lambda: flash_attention_wide_v(qs, ks, pool),
                lambda: dense_attention_with_lse(qs[:, :sub], ks[:, :sub], pool[:, :sub]), 5, 1,
                False, *_dense_work(qs, ks, pool),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, pool),
                heads=sub)
    del qs, ks, pool
    kf, vf = (torch.randn((h, n_k * 128, d), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    got, want = pack_kv(kf, vf), _pack_kv_reference(kf, vf)
    blocks = (h, n_k, 128, d)
    stack = lambda: torch.stack([kf.view(blocks), vf.view(blocks)], dim=2)
    pack_ms, stack_ms = _cuda_ms_turns(torch, [lambda: pack_kv(kf, vf), stack], 20)
    record("pack_kv", f"14b k,v [{h},{n_k * 128},{d}] -> [{h},{2 * n_k * 128},{d}]",
           torch.equal(got, want), _max_err(got, want), pack_ms,
           _cuda_ms(torch, lambda: _pack_kv_reference(kf, vf), 5), "bit exact", False, 0.0,
           _nbytes(kf, vf, got), stack_ms)
    del kf, vf, got, want
    # norm_rope (#4) at the 14B q/k width: 40 heads of 128 over the 21 x 45 x
    # 80 latent grid, 640 launches a 14B clip.
    _norm_rope_check(torch, record, gen, dev, h, (21, 45, 80), False)


def check_wan14b_pooled(torch, dev, checks):
    """Phase 12: the pooled-level kernel against its plain version at the
    Wan2.1-14B 720p shapes, one check a level (2 and 4 at the HBM-gather TPU
    kernel's geometry, 8 at the resident-pyramid one), with a level mask
    from the real predictor, and the sparse kernel on its level-1 lists;
    then the whole lane as routed (the level carry) against dense flash
    attention at the same shape."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.attention.masks import mask_to_block_lists
    from blade_torch.kernels.block_sparse_attn import block_sparse_attention, flash_attention
    from blade_torch.kernels.multilevel_attn import (
        multilevel_attention, pooled_level_from_records)
    from blade_torch.kernels.pack import pack_kv_pyramid
    from blade_torch.kernels.ref_attention import (
        block_masked_attention, pooled_level_attention_reference)
    from blade_torch.utils.rng import make_generator

    check_wan14b_predictor(torch, dev, checks)
    gen = make_generator(2026, dev)
    record = _recorder(checks)
    cfg, dit = C.derive_asa_config(C.WAN_14B_720P, "multilevel"), C.WAN_14B_720P.dit
    h, d, length = dit.num_heads, dit.head_dim, cfg.seq_len
    assert (h, d, length) == (40, 128, 75600)  # 591 key blocks: past the fused rule
    q, k, v = (torch.randn((1, h, length, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    levels = asa.compute_mask(q, k, cfg, generator=make_generator(19, dev))
    n_kt = -(-length // 128)
    assert levels.shape == (1, h, n_kt, n_kt), levels.shape
    q3 = q.reshape(h, length, d)
    records = pack_kv_pyramid(k.reshape(h, length, d), v.reshape(h, length, d))
    scale = 1.0 / math.sqrt(d)
    for level, rec in zip((2, 4, 8), records[1:]):
        seg, pvl = 128 // level, -(-length // level)
        mask = (levels == level).reshape(h, n_kt, n_kt)
        idx, cnt = (t.contiguous() for t in mask_to_block_lists(mask))
        pooled = rec.view(h, n_kt, 2, seg, d)
        k_pool, v_pool = (pooled[:, :, i].reshape(h, n_kt * seg, d) for i in (0, 1))
        pairs = _level_pairs(idx, cnt, length, length, level, 128)
        library, attn_mask = None, None
        if level == 8:  # the one level whose token mask fits beside the rest (57.2 GB)
            attn_mask = _additive_mask(torch, mask[None], length, seg, pvl)
            kp, vp = (t[None, :, :pvl] for t in (k_pool, v_pool))
            library = lambda: _masked_sdpa(torch, q, kp, vp, attn_mask)
        _attn_check(torch, record, "pooled_level_fwd",
                    f"level {level} q [1,{h},{length},{d}] pyramid "
                    f"{rec[0].numel() * 2 / 2**20:.2f} MiB/head key share "
                    f"{pairs / (h * float(length) ** 2):.4f}",
                    lambda: pooled_level_from_records(q3, rec, idx, cnt, level=level,
                                                      scale=scale, pooled_valid_len=pvl),
                    lambda: pooled_level_attention_reference(
                        q3, k_pool, v_pool, mask, level=level, scale=scale,
                        pooled_valid_len=pvl),
                    10, 1, level == 2, 4.0 * d * pairs, _nbytes(q3, rec, idx, cnt),
                    library=library)
        del library, attn_mask
        torch.cuda.empty_cache()
        print(f"pooled level {level}: mean blocks a row {cnt.float().mean().item():.2f}")
    del records
    # Level 1: the sparse kernel (#2) over the 14B level-1 lists, its plain
    # version on the first `sub` heads.
    mask1, sub = levels == 1, 4
    _attn_check(torch, record, "sparse_fwd",
                f"14b level 1 q,k,v [1,{h},{length},{d}] density "
                f"{mask1.float().mean().item():.4f} {_row_blocks(mask1)} (plain: {sub} heads)",
                lambda: block_sparse_attention(q, k, v, mask1),
                lambda: block_masked_attention(q[:, :sub], k[:, :sub], v[:, :sub],
                                               mask1[:, :sub], block_k=128),
                5, 1, False, 4.0 * d * _block_pairs(mask1, length, length),
                _nbytes(q, k, v, mask1), heads=sub)
    del mask1
    lane_ms = _cuda_ms(torch, lambda: multilevel_attention(q, k, v, levels), 3)
    dense_ms = _cuda_ms(torch, lambda: flash_attention(q, k, v), 2)
    print(f"wan14b attention at [1,{h},{length},{d}]: multilevel lane as routed "
          f"{lane_ms:.2f} ms (level mask in, merged out), dense flash {dense_ms:.2f} ms")
    return lane_ms, dense_ms


def _carry_vs_per_level(torch, q, k, v, levels):
    """(max |err|, max |out|) of the level carry's output against the
    per-level lane's (``fused=False``) on the same level mask: one f32
    carry and one bf16 rounding against four bf16 outputs merged in f32,
    held to four bf16 ulps at the largest output."""
    from blade_torch.kernels.multilevel_attn import multilevel_attention

    with torch.no_grad():
        out, _ = multilevel_attention(q, k, v, levels)
        lane, _ = multilevel_attention(q, k, v, levels, fused=False)
    err, ref = _max_err(out, lane), lane.float().abs().max().item()
    assert err <= 2 ** -6 * ref, (err, ref)
    return err, ref


def check_wan14b_carry(torch, dev, checks):
    """Phase 12, last part: the level carry at Wan2.1-14B 720p shapes (B=1,
    H=40, d=128, L=75600, 591 key blocks; a 128-row level mask from the real
    predictor): the multi-level kernel alone over the mask's four lists
    against its plain version on 4 heads; the list building alone; the carry
    whole (lists, pyramid pack, one multi-level launch) in turns (A B B A)
    with the per-level lane whole (``fused=False``), and the carry's output
    against the per-level lane's.  On a package without the carry both
    sides run the per-level lane."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.kernels.multilevel_attn import (
        levels_to_lists, multilevel_attention, multilevel_from_records)
    from blade_torch.kernels.pack import pack_kv_pyramid
    from blade_torch.kernels.ref_attention import multilevel_lists_attention
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2026, dev)
    record = _recorder(checks)
    cfg, dit = C.derive_asa_config(C.WAN_14B_720P, "multilevel"), C.WAN_14B_720P.dit
    h, d, length = dit.num_heads, dit.head_dim, cfg.seq_len
    assert (h, d, length) == (40, 128, 75600)
    q, k, v = (torch.randn((1, h, length, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    levels = asa.compute_mask(q, k, cfg, generator=make_generator(19, dev))
    lists_ms = _cuda_ms(torch, lambda: levels_to_lists(levels), 5)
    carry_ms, lane_ms = _cuda_ms_turns(
        torch, [lambda: multilevel_attention(q, k, v, levels),
                lambda: multilevel_attention(q, k, v, levels, fused=False)], 3)
    err, ref = _carry_vs_per_level(torch, q, k, v, levels)
    idx, cnt = levels_to_lists(levels)
    records = pack_kv_pyramid(k.reshape(h, length, d), v.reshape(h, length, d))
    scale, sub = 1.0 / math.sqrt(d), 4
    pairs = _multilevel_pairs(idx, cnt, length, length, 128)
    _attn_check(torch, record, "multilevel_fwd",
                f"14b level carry q [1,{h},{length},{d}] cap {idx.shape[-1]} key share "
                f"{pairs / (h * float(length) ** 2):.4f} (plain: {sub} heads)",
                lambda: multilevel_from_records(q, records, idx, cnt, length, 128, scale),
                lambda: multilevel_lists_attention(
                    q[:, :sub], k[:, :sub], v[:, :sub], (idx[:, :sub], cnt[:, :sub]),
                    q_rows=128, scale=scale),
                10, 1, False, 4.0 * d * pairs, _nbytes(q, *records, idx, cnt), heads=sub)
    res = dict(carry_ms=carry_ms, per_level_ms=lane_ms, lists_ms=lists_ms,
               carry_vs_per_level_err=err, max_abs_out=ref)
    print(f"wan14b level carry [1,{h},{length},{d}] (whole: lists, pyramid pack, #11) vs "
          f"per-level lane whole (fused=False: #3, #2, pyramid, #9/#10 x3, f32 merge), in "
          f"turns: " + json.dumps(res))
    return res


def serve_wan14b(torch, dev):
    """Phase 13: one full-width, full-depth Wan2.1-T2V-14B 720p request on
    the level carry after a warm-up DiT forward, then one
    dense-attention forward of the same module (the same parameter
    storage)."""
    from blade_torch.cli.inference import build_pipeline, get_args, random_text_embeds
    from blade_torch.models.layers import dense_attention_fn
    from blade_torch.utils.rng import make_generator

    args = get_args(["--preset", "wan-14b-720p", "--mask_mode", "multilevel",
                     "--random-init", "--seed", "8888", "--steps", "8"])
    t0 = time.perf_counter()
    pipe = build_pipeline(args)
    torch.cuda.synchronize()
    params = list(pipe.dit.parameters())
    by_dtype = {}
    for p in params:
        by_dtype[str(p.dtype)] = by_dtype.get(str(p.dtype), 0) + p.numel() * p.element_size()
    n_params = sum(p.numel() for p in params)
    print(f"wan14b pipeline built (random weights, seed 0, lane {pipe.mask_mode}) in "
          f"{time.perf_counter() - t0:.2f} s; DiT params {n_params / 1e9:.3f} B, bytes "
          + json.dumps({k: round(b / 1e9, 3) for k, b in by_dtype.items()})
          + f"; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    c = pipe.preset.dit
    assert pipe.mask_mode == "multilevel" and (c.num_layers, c.dim, c.num_heads) == (40, 5120, 40)
    text = random_text_embeds(pipe, "a corgi surfing a wave at sunset")
    assert text.shape == (1, 512, 4096)
    tstep = torch.full((1,), 999.0, device=dev)
    lat0 = torch.randn(pipe.latent_shape(1), generator=make_generator(5, dev),
                       device=dev).to(pipe.dtype)
    with torch.inference_mode():
        t = time.perf_counter()
        pipe.dit(lat0, tstep, text, attn_kwargs={"generator": make_generator(6, dev)})
        torch.cuda.synchronize()
    print(f"wan14b warm-up forward {1000 * (time.perf_counter() - t):.1f} ms")
    results, launches, lat = _requests(torch, pipe, text, args.seed, args.steps,
                                       (1, 81, 720, 1280, 3), n=1)
    n = c.num_layers * args.steps
    want = {"dense_fwd": 2 * n, "multilevel_fwd": n, "pack_kv_pyramid": n,
            "norm_rope": 2 * n, "heads_pack": 3 * n, "heads_unpack": n,
            **_glue_launches(c.num_layers, args.steps)}
    for name, count in launches.items():
        assert count == want.get(name, 0), (name, count, want.get(name, 0))

    # One forward of the same module (same parameter storage, no second copy
    # of the 28 GB of weights) with dense flash attention.
    sparse_fn, pipe.dit.attention_fn = pipe.dit.attention_fn, dense_attention_fn
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t = time.perf_counter()
            v = pipe.dit(lat, tstep, text)
            torch.cuda.synchronize()
            dense_ms = 1000 * (time.perf_counter() - t)
    finally:
        pipe.dit.attention_fn = sparse_fn
    assert torch.isfinite(v).all()
    print(f"wan14b dense-attention forward {dense_ms:.1f} ms; level-carry step "
          f"{results[0]['step_ms']:.1f} ms")
    return results, launches, dense_ms, n_params


def wan14b_reference_check(torch, dev):
    """Phase 14, the twin of phases 5 and 11 past the fused lane's rule, and
    of phase 7 for its gradient: a small Wan (2 layers of width 128, one
    head of 128) over a 21 x 32 x 52 latent grid, 34 944 tokens in 273 key
    blocks, so the lane choice itself picks the level carry on the card and
    the per-level lane on the CPU; kernels (bf16, card) against plain
    versions (f32, CPU) with shared weights and
    adapters and the card's int level masks replayed: the velocity and the
    LoRA gradients of one loss, from one forward and backward each."""
    from blade_torch.attention.asa import ASAConfig
    from blade_torch.attention.integration import asa_model_kwargs
    from blade_torch.kernels.multilevel_attn import fused_supported
    from blade_torch.models.wan_dit import WanConfig, WanModel
    from blade_torch.utils.rng import make_generator

    cfg = WanConfig(dim=128, ffn_dim=256, num_layers=2, num_heads=1, text_dim=64, freq_dim=32)
    asa_cfg = ASAConfig(latent_width=52, latent_height=32, latent_frames=21, sample_gap=30,
                        max_retain_ratio=0.2, mask_mode="multilevel")
    assert not fused_supported(128, asa_cfg.seq_len)
    card = WanModel(cfg, dtype=torch.bfloat16, device=dev, **asa_model_kwargs(asa_cfg)).eval()
    card.random_init_(make_generator(41, dev))
    cpu = WanModel(cfg, dtype=torch.float32, **asa_model_kwargs(asa_cfg)).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    card.requires_grad_(False)
    cpu.requires_grad_(False)
    g = torch.Generator().manual_seed(42)
    x = torch.randn(1, 16, 21, 64, 104, generator=g)
    text = torch.randn(1, 8, 64, generator=g)
    cot = torch.randn(x.shape, generator=g)
    lora = _test_lora(torch, cpu, g, 44)
    inputs = (x, torch.tensor([700.0]), text)
    got, v_card, levels = _lora_grads(torch, card, lora, inputs, cot, dev,
                                      generator=make_generator(43, dev), collect_mask=True)
    t0 = time.perf_counter()
    want, v_cpu, _ = _lora_grads(torch, cpu, lora, inputs, cot, torch.device("cpu"),
                                 masks=levels.cpu())
    cpu_s = time.perf_counter() - t0
    err = (v_card.float().cpu() - v_cpu).abs().max().item()
    scale = v_cpu.abs().max().item()
    g_err = max((got[k] - want[k]).abs().max().item() for k in want)
    g_ref = max(w.abs().max().item() for w in want.values())
    shares = {lv: round((levels == lv).float().mean().item(), 4) for lv in (0, 1, 2, 4, 8)}
    print(f"wan14b-lane reference check: v max_abs_err {err:.4e} (|ref| max {scale:.3f}), "
          f"LoRA grads max_abs_err {g_err:.4e} over {len(want)} factors (|ref| max "
          f"{g_ref:.3f}); bf16 kernels on the card vs f32 plain on the CPU (forward and "
          f"backward in {cpu_s:.1f} s), level shares {shares}, tol 5e-2*|ref|max each")
    assert torch.isfinite(v_card).all() and levels.shape == (2, 1, 1, 273, 273)
    assert levels.dtype == torch.int32 and all(shares[lv] > 0 for lv in (1, 2, 4, 8))
    assert all(torch.isfinite(v).all() for v in got.values())
    assert err <= 5e-2 * scale, (err, scale)
    assert g_err <= 5e-2 * g_ref, (g_err, g_ref)
    return err, g_err


def _with_union(bsa, fn):
    """Run ``fn()`` with ``SPARSE_UNION`` set; the flag is restored even when
    ``fn`` raises (and the exception propagates)."""
    old = bsa.SPARSE_UNION
    bsa.SPARSE_UNION = True
    try:
        return fn()
    finally:
        bsa.SPARSE_UNION = old


def check_last_kernels(torch, dev, checks):
    """Phase 15: the "max" predictor's pooled-scores kernel (#13) at three
    shapes, the union-gathered sparse forward (#14, the gather kernel's union
    walk) at Wan 480p on a mask from the real energy predictor with one
    forced empty row (beside the 128-row sparse kernel, #2, on the same
    mask: the same tensor-core work, so the times compare), and the head
    relayouts (#15), bit exact, at the Wan 1.3B and 14B q/k widths."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.attention.masks import pooled_scores_plain, union_block_lists
    from blade_torch.kernels import block_sparse_attn as bsa
    from blade_torch.kernels.norm_rope import (
        _heads_pack_reference, _heads_unpack_reference, heads_pack, heads_unpack)
    from blade_torch.kernels.pooled_predictor import pooled_scores
    from blade_torch.kernels.ref_attention import block_masked_attention
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2027, dev)
    record = _recorder(checks)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # -- pooled predictor (#13).  Tolerance: max |err| <= 1e-3 * max |ref| and
    # rows summing to 1 within 1e-4: both sides take the same bf16 inputs, so
    # they differ by f32 sums in another order and ex2.approx only.
    for name, h, nblk, d, tpb, main in (
            ("wan 480p, 32 tokens", 12, 256, 128, 32, True),
            ("cogvideox 480p, 32 tokens", COG_HEADS, -(-COG_TOKENS // 128), COG_HEAD_DIM, 32,
             False),
            ("wan 480p, 16 tokens", 12, 256, 128, 16, False)):
        ls = nblk * tpb
        qs, ks = randn(1, h, ls, d), randn(1, h, ls, d)
        scale = 1.0 / math.sqrt(d)
        got = pooled_scores(qs, ks, tpb)
        want = pooled_scores_plain(qs, ks, tpb, scale)
        err, ref = _max_err(got, want), want.abs().max().item()
        rowsum = (got.sum(-1) - 1.0).abs().max().item()
        record("pooled_predictor", f"{name} q_s,k_s [1,{h},{ls},{d}] -> Po [1,{h},{nblk},{nblk}]",
               err <= 1e-3 * ref and rowsum <= 1e-4, err,
               _cuda_ms(torch, lambda: pooled_scores(qs, ks, tpb), 20),
               _cuda_ms(torch, lambda: pooled_scores_plain(qs, ks, tpb, scale), 3),
               f"Po {err:.3e} <= 1e-3*max|ref| ({ref:.4e}), |row sum - 1| {rowsum:.1e} <= 1e-4",
               main, 2.0 * h * ls * ls * d, _nbytes(qs, ks, got))

    # -- union-gathered sparse forward (#14) ---------------------------------
    h, d, L = 12, 128, 32760
    q, k, v = (randn(1, h, L, d) for _ in range(3))
    cfg = C.derive_asa_config(C.WAN_480P)
    mask = asa.compute_mask(q, k, cfg, generator=make_generator(7, dev))
    mask[0, 5, 100] = False  # one forced empty row
    n_k = mask.shape[-1]
    bound = 2 * (max(int(n_k * cfg.max_retain_ratio), 1) + 2)

    def union():
        return _with_union(bsa, lambda: bsa.block_sparse_attention(q, k, v, mask,
                                                                   union_bound=bound))

    out, lse = union()
    assert out[0, 5, 100 * 128:101 * 128].abs().max().item() == 0.0
    assert lse[0, 5, 100 * 128:101 * 128].max().item() <= -1e29
    density = mask.float().mean().item()
    _, u_cnt, _ = union_block_lists(mask.reshape(h, n_k, n_k), group=2, bound=bound)
    rows_sum = mask.sum().item()
    attn_mask = _additive_mask(torch, mask, L)
    _attn_check(torch, record, "sparse_union_fwd",
                f"q,k,v [1,12,32760,128] density {density:.4f} union bound {bound}", union,
                lambda: block_masked_attention(q, k, v, mask, block_k=128), 10, 1, True,
                4.0 * d * _block_pairs(mask, L, L), _nbytes(q, k, v, mask),
                library=lambda: _masked_sdpa(torch, q, k, v, attn_mask))
    del attn_mask
    torch.cuda.empty_cache()
    union_ms = checks["sparse_union_fwd"][-1]["ms"]
    rows_ms = _cuda_ms(torch, lambda: bsa.block_sparse_attention(q, k, v, mask), 10)
    # Both kernels stage each row's selected blocks once (a CTA a mask row);
    # the union's distinct blocks a pair are what HBM must give when the
    # pair's second CTA reads the shared ones from L2.
    print(f"union vs 128-row sparse forward on the same mask: sparse_union_fwd {union_ms:.3f} ms, "
          f"sparse_fwd {rows_ms:.3f} ms ({union_ms / rows_ms:.3f}x); K/V blocks staged "
          f"{int(rows_sum)} by each, distinct a pair {int(u_cnt.sum().item())} (share "
          f"{u_cnt.sum().item() / rows_sum:.4f})")
    del q, k, v, out, lse

    # -- head relayouts (#15), bit exact; the library call is PyTorch's own
    # strided copy.
    for shape, h, main in (((1, 32760, 1536), 12, True), ((1, 75600, 5120), 40, False)):
        b, s, dim = shape
        x = randn(*shape)
        packed, want = heads_pack(x, h), _heads_pack_reference(x, h)
        record("heads_pack", f"x [{b},{s},{dim}] -> [{b},{h},{s},{dim // h}] bf16",
               torch.equal(packed, want), _max_err(packed, want),
               _cuda_ms(torch, lambda: heads_pack(x, h), 20),
               _cuda_ms(torch, lambda: _heads_pack_reference(x, h), 20), "bit exact", main,
               0.0, _nbytes(x, packed),
               _cuda_ms(torch, lambda: x.view(b, s, h, dim // h).transpose(1, 2).contiguous(),
                        20))
        back, want = heads_unpack(packed), _heads_unpack_reference(packed)
        record("heads_unpack", f"[{b},{h},{s},{dim // h}] -> x [{b},{s},{dim}] bf16",
               torch.equal(back, want) and torch.equal(back, x), _max_err(back, want),
               _cuda_ms(torch, lambda: heads_unpack(packed), 20),
               _cuda_ms(torch, lambda: _heads_unpack_reference(packed), 20), "bit exact", main,
               0.0, _nbytes(packed, back),
               _cuda_ms(torch, lambda: packed.transpose(1, 2).contiguous().view(b, s, dim), 20))
        del x, packed, back, want


def _density_shim(torch, pipe):
    """Measurement shim: wrap the DiT's ``attention_fn`` so that every
    energy mask of the requests that follow is collected and its density
    summed on the card.  Returns ``(densities, restore)``."""
    fn = pipe.dit.attention_fn
    densities = []

    def collecting(q, k, v, **kw):
        out, mask = fn(q, k, v, collect_mask=True, **kw)
        densities.append(mask.float().mean())
        return out

    def restore():
        pipe.dit.attention_fn = fn

    pipe.dit.attention_fn = collecting
    return densities, restore


def serve_maxpred(torch, dev, stock):
    """Phase 16, path (a): two full-width ``wan-1.3b-480p`` requests with
    the reference-parity predictor (``asa_predictor="max"``, 32 tokens a
    block), exact launch counts, every mask's density, then a small-input
    reference check with the card's offsets replayed."""
    import dataclasses

    from blade_torch import config as C
    from blade_torch.cli.inference import build_pipeline, get_args, random_text_embeds

    preset = dataclasses.replace(C.WAN_480P, asa_predictor="max", asa_sample_tokens=32)
    args = get_args(["--preset", "wan-1.3b-480p", "--random-init", "--seed", "8888",
                     "--steps", "8"])
    pipe = build_pipeline(args, preset=preset)
    cfg = C.derive_asa_config(pipe.preset)
    assert (cfg.predictor, cfg.sample_tokens_per_block) == ("max", 32)
    text = random_text_embeds(pipe, "a corgi surfing a wave at sunset")
    densities, restore = _density_shim(torch, pipe)
    try:
        results, launches, _ = _requests(torch, pipe, text, args.seed, args.steps,
                                         (1, 81, 480, 832, 3))
    finally:
        restore()
    n = pipe.preset.dit.num_layers * args.steps
    want = {"pooled_predictor": n, "dense_fwd": 2 * n, "sparse_fwd": n, "pack_kv": n,
            "norm_rope": 2 * n, "heads_pack": 3 * n, "heads_unpack": n,
            **_glue_launches(pipe.preset.dit.num_layers, args.steps)}
    for name, count in launches.items():  # per request
        assert count == 2 * want.get(name, 0), (name, count, 2 * want.get(name, 0))
    assert len(densities) == 2 * n
    density = torch.stack(densities).mean().item()
    warm = results[1]
    print("maxpred request vs the stock preset's (phase 4, warm): " + json.dumps({
        key: [warm[key], stock[key]] for key in ("step_ms", "denoise_s", "decode_s", "clip_s")})
        + f"; mask density {density:.4f} over {len(densities)} masks")
    del pipe
    err = maxpred_reference_check(torch, dev)
    return results, launches, density, err


def maxpred_reference_check(torch, dev):
    """Phase 16, second half, the twin of phase 5 with ``predictor="max"``
    and 32 tokens a block: kernels (bf16, card) against plain versions (f32,
    CPU) on shared weights, with the offsets the card drew replayed on the
    CPU (a measurement shim over ``masks.sample_offsets``), so the CPU runs
    its own plain predictor on the same samples.  bf16 q/k can flip a
    near-tied block at the energy threshold: the masks must agree on 95 % of
    their entries, the velocities to 5e-2 * |ref| max."""
    from blade_torch.attention import masks as M
    from blade_torch.utils.rng import make_generator

    card, cpu = _small_asa_models(torch, dev, 51, predictor="max", sample_tokens_per_block=32)
    g = torch.Generator().manual_seed(52)
    x = torch.randn(1, 16, 4, 30, 32, generator=g)
    text = torch.randn(1, 8, 64, generator=g)
    t = torch.tensor([700.0])
    drawn, sample_offsets = [], M.sample_offsets

    def recording(*a, **kw):
        drawn.append(sample_offsets(*a, **kw))
        return drawn[-1]

    try:
        with torch.inference_mode():
            M.sample_offsets = recording
            v_card, m_card = card(x.to(dev), t.to(dev), text.to(dev),
                                  attn_kwargs={"generator": make_generator(53, dev),
                                               "collect_mask": True})
            replay = iter(drawn)
            M.sample_offsets = lambda *a, **kw: next(replay)
            v_cpu, m_cpu = cpu(x, t, text, attn_kwargs={"generator": make_generator(54),
                                                        "collect_mask": True})
    finally:
        M.sample_offsets = sample_offsets
    assert len(drawn) == 4  # q and k offsets of each of the 2 layers
    err = (v_card.float().cpu() - v_cpu).abs().max().item()
    scale = v_cpu.abs().max().item()
    agree = (m_card.cpu() == m_cpu).float().mean().item()
    print(f"maxpred reference check: velocity max_abs_err {err:.4e} (bf16 kernels on the card "
          f"vs f32 plain on the CPU, offsets replayed, |ref| max {scale:.3f}, mask density "
          f"{m_card.float().mean().item():.3f}, masks agree on {agree:.4f} of entries; tol "
          f"5e-2*|ref|max, agreement >= 0.95)")
    assert torch.isfinite(v_card).all() and agree >= 0.95, agree
    assert err <= 5e-2 * scale, (err, scale)
    return err


def serve_union(torch, dev, stock):
    """Phase 17, path (b): the stock ``wan-1.3b-480p`` preset with
    ``SPARSE_UNION`` set, one request after a warm-up forward, exact launch
    counts and every mask's density (the stock predictor's)."""
    from blade_torch.cli.inference import build_pipeline, get_args, random_text_embeds
    from blade_torch.kernels import block_sparse_attn as bsa
    from blade_torch.utils.rng import make_generator

    args = get_args(["--preset", "wan-1.3b-480p", "--random-init", "--seed", "8888",
                     "--steps", "8"])
    pipe = build_pipeline(args)
    text = random_text_embeds(pipe, "a corgi surfing a wave at sunset")
    tstep = torch.full((1,), 999.0, device=dev)
    lat0 = torch.randn(pipe.latent_shape(1), generator=make_generator(5, dev),
                       device=dev).to(pipe.dtype)

    def run():
        with torch.inference_mode():
            pipe.dit(lat0, tstep, text, attn_kwargs={"generator": make_generator(6, dev)})
            torch.cuda.synchronize()
        densities, restore = _density_shim(torch, pipe)
        try:
            return _requests(torch, pipe, text, args.seed, args.steps, (1, 81, 480, 832, 3),
                             n=1) + (densities,)
        finally:
            restore()

    results, launches, _, densities = _with_union(bsa, run)
    assert bsa.SPARSE_UNION is False
    n = pipe.preset.dit.num_layers * args.steps
    want = {"sparse_union_fwd": n, "dense_fwd": 3 * n, "norm_rope": 2 * n, "heads_pack": 3 * n,
            "heads_unpack": n, **_glue_launches(pipe.preset.dit.num_layers, args.steps)}
    for name, count in launches.items():  # no sparse_fwd, no pack_kv: K/V in place
        assert count == want.get(name, 0), (name, count, want.get(name, 0))
    density = torch.stack(densities).mean().item()
    print(f"union request step {results[0]['step_ms']:.1f} ms vs the stock preset's "
          f"{stock['step_ms']:.1f} ms (phase 4, warm); clip {results[0]['clip_s']:.3f} s vs "
          f"{stock['clip_s']:.3f} s; stock-predictor mask density {density:.4f}")
    return results, launches, density


def check_cog_pooled_fwd(torch, dev, checks):
    """Phase 18, first check: the dense kernel as the energy lane's pooled
    branch at CogVideoX-5B 480p training shapes (d = 64: q [1,48,17776,64]
    against K/V mean-pooled by the preset's gap, +log gap bias); the library
    call is one SDPA on the same inputs."""
    from blade_torch import config as C
    from blade_torch.attention.masks import pad_to_block_multiple
    from blade_torch.kernels.block_sparse_attn import flash_attention
    from blade_torch.kernels.ref_attention import dense_attention_with_lse
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2033, dev)
    record = _recorder(checks)
    cfg = C.derive_asa_config(C.COGVIDEOX_480P, "energy")
    h, d, length, gap = COG_HEADS, COG_HEAD_DIM, cfg.seq_len, cfg.sample_gap
    q, k, v = (torch.randn((1, h, length, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    kp, vp = (pad_to_block_multiple(t, gap).float().reshape(1, h, -1, gap, d).mean(3)
              .to(torch.bfloat16) for t in (k, v))
    bias = math.log(gap)
    _attn_check(torch, record, "dense_fwd",
                f"cog pooled q [1,{h},{length},{d}] k,v [1,{h},{kp.shape[2]},{d}]",
                lambda: flash_attention(q, kp, vp, bias=bias),
                lambda: dense_attention_with_lse(q, kp, vp, bias=bias), 20, 3, False,
                *_dense_work(q, kp, vp),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(q, kp, vp))


def check_cog_energy(torch, dev, checks):
    """Phase 18: the d = 64 forms of the energy lane's kernels at the
    CogVideoX-5B 480p training shapes (B=1, H=48, d=64, L=17776 with the 226
    text tokens, an energy mask from the real predictor plus one forced
    empty row and one key block no row selected): the sparse forward and
    ``pack_kv`` against their plain versions, the sparse backward kernels,
    and the dense backward kernels on the pooled branch (K/V pooled by the
    preset's gap, +log gap bias), each pair with delta."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.attention.masks import pad_to_block_multiple
    from blade_torch.kernels.block_sparse_attn import block_sparse_attention
    from blade_torch.kernels.pack import _pack_kv_reference, pack_kv
    from blade_torch.kernels.ref_attention import block_masked_attention
    from blade_torch.utils.rng import make_generator

    check_cog_pooled_fwd(torch, dev, checks)
    gen = make_generator(2031, dev)
    record = _recorder(checks)
    cfg = C.derive_asa_config(C.COGVIDEOX_480P, "energy")
    h, d, length, gap = COG_HEADS, COG_HEAD_DIM, cfg.seq_len, cfg.sample_gap
    assert length == COG_TOKENS and cfg.text_length == 226

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = (randn(1, h, length, d) for _ in range(3))
    mask = asa.compute_mask(q, k, cfg, generator=make_generator(29, dev))
    mask[0, 7, 30] = False  # one forced empty row
    mask[0, 8, :, 20] = False  # one key block that no row selected
    density = mask.float().mean().item()
    kf, vf = k.reshape(h, length, d), v.reshape(h, length, d)
    rec = pack_kv(kf, vf)
    want = _pack_kv_reference(kf, vf)
    record("pack_kv", f"cog k,v [{h},{length},{d}]", torch.equal(rec, want),
           _max_err(rec, want), _cuda_ms(torch, lambda: pack_kv(kf, vf), 20),
           _cuda_ms(torch, lambda: _pack_kv_reference(kf, vf), 5), "bit exact", False, 0.0,
           _nbytes(kf, vf, rec))
    pairs = _block_pairs(mask, length, length)
    attn_mask = _additive_mask(torch, mask, length)
    _attn_check(torch, record, "sparse_fwd",
                f"cog q,k,v [1,{h},{length},{d}] density {density:.4f}",
                lambda: block_sparse_attention(q, k, v, mask),
                lambda: block_masked_attention(q, k, v, mask, block_k=128), 5, 1, False,
                4.0 * d * pairs, _nbytes(q, k, v, mask),
                library=lambda: _masked_sdpa(torch, q, k, v, attn_mask))
    scale = 1.0 / math.sqrt(d)
    _bwd_check(torch, record, gen, "sparse", f"cog q,k,v,dO [1,{h},{length},{d}] density "
               f"{density:.4f}", q, k, v, mask, 0.0, reps=3,
               library=lambda g: _efficient_bwd_library(torch, q, k, v, g, attn_mask, scale))
    del attn_mask
    torch.cuda.empty_cache()
    kp, vp = (pad_to_block_multiple(t, gap).float().reshape(1, h, -1, gap, d).mean(3)
              .to(torch.bfloat16) for t in (k, v))
    _bwd_check(torch, record, gen, "dense",
               f"cog pooled q,dO [1,{h},{length},{d}] k,v [1,{h},{kp.shape[2]},{d}]",
               q, kp, vp, None, math.log(gap), reps=10,
               library=lambda g: _dense_bwd_library(torch, q, kp, vp, g, scale))
    return density


def _pooled_bwd_check(torch, record, shape, q, rec, out, lse, g_out, g_lse, delta, mask,
                      level, lk, heads, reps, main, library=False):
    """Both pooled backward kernels of one level (``q, out, g_out [BH, Lq,
    d]``, the level's records, a 128-row mask ``[BH, n_qt, n_kt]``) timed on
    every head and held against the plain pooled backward on the first
    ``heads`` heads at full sequence length.  With ``library``, both are
    timed in turns with one memory-efficient SDPA backward over the level's
    pooled K/V (its mask ``log L`` / -inf, ``out`` and ``lse`` as given)."""
    from blade_torch.attention.masks import mask_to_block_lists
    from blade_torch.kernels.multilevel_attn import (
        pooled_level_dkv_from_records, pooled_level_dq_from_records)
    from blade_torch.kernels.ref_attention import pooled_level_backward_reference

    bh, lq, d = q.shape
    seg, pvl = 128 // level, -(-lk // level)
    n_kt = rec.shape[1] // (2 * seg)
    idx, cnt = (t.contiguous() for t in mask_to_block_lists(mask))
    t_idx, t_cnt = (t.contiguous() for t in mask_to_block_lists(mask.transpose(-1, -2)))
    kw = dict(level=level, scale=1.0 / math.sqrt(d), pooled_valid_len=pvl)
    stats = (q, rec, out, lse, g_out, g_lse, delta)

    def dq_fn():
        return pooled_level_dq_from_records(*stats, idx, cnt, **kw)

    def dkv_fn():
        return pooled_level_dkv_from_records(*stats, t_idx, t_cnt, **kw)

    got = {"dq": dq_fn()}
    got["dk"], got["dv"] = dkv_fn()
    hs = slice(0, heads)
    pooled = rec[hs].view(heads, n_kt, 2, seg, d)
    k_pool, v_pool = (pooled[:, :, i].reshape(heads, n_kt * seg, d) for i in (0, 1))

    def plain():
        return pooled_level_backward_reference(
            q[hs], k_pool, v_pool, out[hs], lse[hs], g_out[hs], g_lse[hs], mask[hs],
            delta=delta[hs], **kw)

    want = dict(zip(("dq", "dk", "dv"), plain()))
    for name, g in got.items():
        assert torch.isfinite(g.float()).all(), (shape, name)
    if pvl < n_kt * seg:  # dead pooled rows get nothing
        assert all(g[:, pvl:].float().abs().max().item() == 0.0
                   for g in (got["dk"], got["dv"]))
    plain_ms = _cuda_ms(torch, plain, 1)
    pairs = _level_pairs(idx, cnt, lq, lk, level, 128)
    nbytes = _nbytes(q, rec, g_out, lse, g_lse, delta, idx, cnt)
    work = {"dq": (6.0 * d * pairs, nbytes + _nbytes(got["dq"])),
            "dkv": (8.0 * d * pairs, nbytes + _nbytes(got["dk"], got["dv"]))}
    calls = None
    if library:
        attn_mask = _additive_mask(torch, mask[None], lq, seg, pvl, value=math.log(level))
        pooled = rec.view(bh, n_kt, 2, seg, d)
        kp, vp = (pooled[:, :, i].reshape(bh, n_kt * seg, d)[None, :, :pvl] for i in (0, 1))
        calls = _efficient_bwd_library(torch, q[None], kp, vp, g_out[None], attn_mask,
                                       kw["scale"], out=out[None], lse=lse[None])
        del attn_mask, kp, vp  # the call holds them until it is freed
    times, lib_ms, lib_name = _time_with_library(torch, [dq_fn, dkv_fn], calls, reps)
    del calls
    torch.cuda.empty_cache()
    for (part, names), ms in zip((("dq", ("dq",)), ("dkv", ("dk", "dv"))), times):
        errs = {n: _max_err(got[n][hs], want[n]) for n in names}
        refs = {n: want[n].float().abs().max().item() for n in names}
        per = ", ".join(f"{n} {errs[n]:.2e}/{refs[n]:.2e}" for n in names)
        record(f"pooled_level_{part}",
               f"{shape} level {level} key share {pairs / (bh * float(lq) * lk):.4f}",
               all(errs[n] <= BWD_REL * refs[n] for n in names), max(errs.values()),
               ms, plain_ms,
               f"2e-2*max|ref| per grad (err/max|ref|: {per}; plain = the level's whole "
               f"backward on heads 0-{heads - 1}, the kernel on all {bh})",
               main and level == 2, *work[part], library_ms=lib_ms,
               library_call=lib_name and f"{lib_name} backward: dq+dk+dv")


def _lane_gradient(torch, name, q, k, v, lane_kw, plain_lists, q_rows, heads, step, gen):
    """The whole lane's dQ, dK, dV (``multilevel_attention``, bf16, every
    head) against torch autograd of its plain version
    (``multilevel_lists_attention`` in f32 on the first ``heads`` heads,
    evaluated ``step`` mask rows at a time: the loss is a sum over query
    rows, so the chunks' gradients add up to the whole); the lane's forward
    and backward timed on every head."""
    from blade_torch.kernels.multilevel_attn import multilevel_attention
    from blade_torch.kernels.ref_attention import multilevel_lists_attention

    g_out = torch.randn(q.shape, generator=gen, device=q.device).to(torch.bfloat16)
    g_lse = torch.randn(q.shape[:3], generator=gen, device=q.device)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out, lse = multilevel_attention(*leaves, **lane_kw)
    got = torch.autograd.grad((out, lse), leaves, (g_out, g_lse), retain_graph=True)
    with torch.no_grad():
        fwd_ms = _cuda_ms(torch, lambda: multilevel_attention(q, k, v, **lane_kw), 3)
    bwd_ms = _cuda_ms(torch, lambda: torch.autograd.grad((out, lse), leaves, (g_out, g_lse),
                                                         retain_graph=True), 3)
    del out, lse
    hs = slice(0, heads)
    qf, kf, vf = (t[:, hs].float().requires_grad_(True) for t in (q, k, v))
    idx, cnt = (t[:, hs] for t in plain_lists)
    length = q.shape[2]
    t0 = time.perf_counter()
    for m0 in range(0, idx.shape[2], step):
        r0, r1 = m0 * q_rows, min(length, (m0 + step) * q_rows)
        o, s = multilevel_lists_attention(qf[:, :, r0:r1], kf, vf,
                                          (idx[:, :, m0:m0 + step], cnt[:, :, m0:m0 + step]),
                                          q_rows=q_rows)
        torch.autograd.backward((o, s), (g_out[:, hs, r0:r1].float(), g_lse[:, hs, r0:r1]))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    errs, refs = {}, {}
    for n, g, w in zip(("dq", "dk", "dv"), got, (qf.grad, kf.grad, vf.grad)):
        assert torch.isfinite(g.float()).all(), (name, n)
        errs[n], refs[n] = _max_err(g[:, hs], w), w.abs().max().item()
    ok = all(errs[n] <= BWD_REL * refs[n] for n in errs)
    res = dict(lane=name, fwd_ms=fwd_ms, bwd_ms=bwd_ms, plain_heads=heads, plain_s=plain_s,
               **{f"{n}_err": errs[n] for n in errs}, **{f"{n}_ref": refs[n] for n in refs})
    print(f"lane gradient {name}: " + json.dumps(res) + f" tol 2e-2*max|ref| {'ok' if ok else 'FAIL'}")
    assert ok, res
    return res


def check_multilevel_backward(torch, dev, checks):
    """Phases 19 and 20: the pooled backward kernels against their plain
    version, then the whole lane's gradient against torch autograd of its
    plain version, with a non-zero LSE cotangent."""
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2032, dev)
    lanes = check_cog_multilevel_backward(torch, dev, checks, gen)
    gc.collect()
    torch.cuda.empty_cache()
    lanes.update(check_wan14b_multilevel_backward(torch, dev, checks, gen))
    return lanes


def check_cog_multilevel_backward(torch, dev, checks, gen=None):
    """Phase 19 at CogVideoX-5B 480p fused-lane shapes (B=1, H=48, d=64,
    L=17776, q_rows 256, lists from the real predictor; p from the merged
    lse): the pooled backward kernels of levels 2, 4, 8, each timed in turns
    with one masked SDPA backward over that level, then the fused lane's
    gradient."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.kernels.multilevel_attn import multilevel_from_records
    from blade_torch.kernels.pack import pack_kv_pyramid
    from blade_torch.kernels.ref_attention import lists_to_level_masks
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2032, dev) if gen is None else gen
    record = _recorder(checks)
    lanes = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # CogVideoX-5B 480p, the fused lane: the four levels' lists of 256-row
    # mask rows, each repeated onto its two 128-row tiles.
    cfg = C.derive_asa_config(C.COGVIDEOX_480P, "multilevel")
    h, d, length, q_rows = COG_HEADS, COG_HEAD_DIM, cfg.seq_len, cfg.multilevel_q_rows
    assert q_rows == 256
    q, k, v = (randn(1, h, length, d) for _ in range(3))
    idx, cnt = asa.compute_lists(q, k, cfg, generator=make_generator(9, dev))
    records = pack_kv_pyramid(k.reshape(h, length, d), v.reshape(h, length, d))
    n_qt, n_kt = -(-length // 128), -(-length // 128)
    with torch.no_grad():
        out, lse = multilevel_from_records(q, records, idx, cnt, length, q_rows,
                                           1.0 / math.sqrt(d))
    g_out = randn(h, length, d)
    g_lse = torch.randn((h, length), generator=gen, device=dev)
    q3, out3 = q.reshape(h, length, d), out.reshape(h, length, d)
    lse3 = lse.reshape(h, length)
    delta = (g_out.float() * out3.float()).sum(-1)
    masks = lists_to_level_masks(idx, cnt, n_kt).repeat_interleave(2, dim=2)[:, :, :n_qt]
    for li, level in ((1, 2), (2, 4), (3, 8)):
        _pooled_bwd_check(torch, record, f"cog fused q [1,{h},{length},{d}] q_rows 256",
                          q3, records[li], out3, lse3, g_out, g_lse, delta,
                          masks[0, :, :, li].contiguous(), level, length, h, 10, True,
                          library=True)
    del records, out, lse, masks
    lanes["cog_fused"] = _lane_gradient(
        torch, f"cog fused [1,{h},{length},{d}] q_rows 256", q, k, v,
        dict(lists=(idx, cnt), q_rows=q_rows), (idx, cnt), q_rows, 4, 8, gen)
    return lanes


def check_wan14b_multilevel_backward(torch, dev, checks, gen=None):
    """Phase 20: the pooled backward kernels and the per-level lane's
    gradient (``fused=False``) at Wan2.1-14B 720p shapes (H=40, d=128,
    L=75600, a 128-row level mask from the real predictor; p from each
    level's own lse), then the level carry's output against the per-level
    lane's and its gradient on the same mask.  No library call: a level's
    token mask would take 229 / 114 / 57 GB beside the rest."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.kernels.multilevel_attn import levels_to_lists, pooled_level_from_records
    from blade_torch.attention.masks import mask_to_block_lists
    from blade_torch.kernels.pack import pack_kv_pyramid
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2034, dev) if gen is None else gen
    record = _recorder(checks)
    lanes = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # Each pooled level against its own (out_l, lse_l).
    cfg = C.derive_asa_config(C.WAN_14B_720P, "multilevel")
    h, d, length = C.WAN_14B_720P.dit.num_heads, C.WAN_14B_720P.dit.head_dim, cfg.seq_len
    assert (h, d, length) == (40, 128, 75600)
    q, k, v = (randn(1, h, length, d) for _ in range(3))
    levels = asa.compute_mask(q, k, cfg, generator=make_generator(19, dev))
    n_kt = -(-length // 128)
    records = pack_kv_pyramid(k.reshape(h, length, d), v.reshape(h, length, d))
    q3 = q.reshape(h, length, d)
    g_out = randn(h, length, d)
    g_lse = torch.randn((h, length), generator=gen, device=dev)
    for level, rec in zip((2, 4, 8), records[1:]):
        mask = (levels == level).reshape(h, n_kt, n_kt)
        lists = (t.contiguous() for t in mask_to_block_lists(mask))
        out_l, lse_l = pooled_level_from_records(q3, rec, *lists, level=level,
                                                 scale=1.0 / math.sqrt(d),
                                                 pooled_valid_len=-(-length // level))
        delta = (g_out.float() * out_l.float()).sum(-1)
        _pooled_bwd_check(torch, record, f"wan14b per-level q [1,{h},{length},{d}]", q3, rec,
                          out_l, lse_l, g_out, g_lse, delta, mask, level, length, 8, 5, False)
        del out_l, lse_l, delta
    del records
    plain_lists = levels_to_lists(levels[:, :2])
    lanes["wan14b_per_level"] = _lane_gradient(
        torch, f"wan14b per-level [1,{h},{length},{d}]", q, k, v,
        dict(levels=levels, fused=False), plain_lists, 128, 2, 8, gen)
    err, ref = _carry_vs_per_level(torch, q, k, v, levels)
    print(f"wan14b level carry vs per-level lane: max_abs_err {err:.3e} (max |out| {ref:.3e}, "
          f"tol 2^-6 of it)")
    lanes["wan14b_carry"] = _lane_gradient(
        torch, f"wan14b level carry [1,{h},{length},{d}]", q, k, v, dict(levels=levels),
        plain_lists, 128, 2, 8, gen)
    return lanes


def multilevel_gradient_check(torch, dev):
    """Phase 21, the multilevel twin of phase 7 on the fused lane (phase 14
    holds the gradient past the fused rule): LoRA gradients of one loss through
    the 2-layer CogVideoX of phase 11 (256-row lists), kernels (bf16, card)
    against plain versions (f32, CPU), shared weights and adapters, the
    card's lists replayed."""
    from blade_torch.attention.asa import ASAConfig
    from blade_torch.attention.integration import asa_model_kwargs
    from blade_torch.models.cogvideox_dit import COGVIDEOX_TINY, CogVideoXModel
    from blade_torch.utils.rng import make_generator

    asa_cfg = ASAConfig(latent_width=16, latent_height=16, latent_frames=4, text_length=16,
                        mask_mode="multilevel", multilevel_q_rows=256)
    card = CogVideoXModel(COGVIDEOX_TINY, dtype=torch.bfloat16, device=dev,
                          **asa_model_kwargs(asa_cfg))
    card.random_init_(make_generator(62, dev))
    cpu = CogVideoXModel(COGVIDEOX_TINY, dtype=torch.float32, **asa_model_kwargs(asa_cfg))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    card.requires_grad_(False)
    cpu.requires_grad_(False)
    g = torch.Generator().manual_seed(61)
    x = torch.randn(1, 4, 16, 32, 32, generator=g)
    text = torch.randn(1, 16, 64, generator=g)
    cot = torch.randn(x.shape, generator=g)
    lora = _test_lora(torch, cpu, g, 64)
    inputs = (x, torch.tensor([700.0]), text)
    got, _, (idx, cnt) = _lora_grads(torch, card, lora, inputs, cot, dev,
                                     generator=make_generator(65, dev), collect_mask=True)
    want, _, _ = _lora_grads(torch, cpu, lora, inputs, cot, torch.device("cpu"),
                             masks=(idx.cpu(), cnt.cpu()))
    err = max((got[k] - want[k]).abs().max().item() for k in want)
    ref = max(w.abs().max().item() for w in want.values())
    counts = cnt.float().mean(dim=(0, 1, 2, 3)).tolist()
    print(f"multilevel gradient check (cogvideox, fused lane): LoRA grads max_abs_err "
          f"{err:.4e} over {len(want)} factors (bf16 kernels on the card vs f32 plain on "
          f"the CPU, |ref| max {ref:.3f}, mean list counts per level "
          f"{[round(c, 2) for c in counts]}, tol 5e-2*|ref|max)")
    assert all(torch.isfinite(v).all() for v in got.values()) and all(c > 0 for c in counts)
    assert err <= 5e-2 * ref, (err, ref)
    return err


def cog_multilevel_gradient(torch, dev):
    """Phase 22: one full-width LoRA gradient of CogVideoX-5B 480p on its
    serving lane (42 blocks, the fused multilevel lane, q_rows 256, remat),
    the gradient JAX's custom VJP defines; exact launch counts a layer."""
    from blade_torch import config as C
    from blade_torch.attention.integration import asa_model_kwargs
    from blade_torch.kernels._build import KERNELS, reset_launch_counts
    from blade_torch.models.cogvideox_dit import CogVideoXModel
    from blade_torch.training.lora import init_lora, merge_lora
    from blade_torch.utils.rng import make_generator

    preset = C.COGVIDEOX_480P
    cfg = C.derive_asa_config(preset)  # the serving default: multilevel
    assert cfg.mask_mode == "multilevel" and cfg.multilevel_q_rows == 256
    t0 = time.perf_counter()
    model = CogVideoXModel(preset.dit, dtype=torch.bfloat16, remat=True, device=dev,
                           **asa_model_kwargs(cfg))
    model.random_init_(make_generator(71, dev))
    model.to(torch.bfloat16).requires_grad_(False)
    base = {n: p.detach() for n, p in model.named_parameters()}
    lora = init_lora(make_generator(72, dev), base, rank=64)
    g = make_generator(73, dev)
    for key in lora:  # non-zero b, so every factor has a gradient
        if key.endswith(".b"):
            lora[key] = 0.01 * torch.randn(lora[key].shape, generator=g, device=dev)
    lat_shape = (1, 13, 16, 60, 90)
    x = torch.randn(lat_shape, generator=g, device=dev).to(torch.bfloat16)
    text = torch.randn((1, 226, 4096), generator=g, device=dev).to(torch.bfloat16)
    cot = torch.randn(lat_shape, generator=g, device=dev)
    t = torch.full((1,), 700.0, device=dev)
    torch.cuda.synchronize()
    print(f"cog multilevel gradient: model built in {time.perf_counter() - t0:.1f} s")

    def grads():
        leaves = {k: v.requires_grad_(True) for k, v in lora.items()}
        v = torch.func.functional_call(model, merge_lora(base, leaves, alpha=64.0, rank=64),
                                       (x, t, text),
                                       {"attn_kwargs": {"generator": make_generator(74, dev)}})
        return torch.autograd.grad((v.float() * cot).sum(), list(leaves.values()))

    grads()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = grads()
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(torch.isfinite(gr).all() for gr in out)
    n = preset.dit.num_layers
    want = {"dense_fwd": 2 * n, "pack_kv_pyramid": 2 * n, "multilevel_fwd": 2 * n,
            "qk_norm_rope": 2 * n, "heads_pack": 2 * n,
            "sparse_dq": n, "sparse_dkv": n, "attn_delta": n, "qk_norm_rope_dx": n,
            "heads_unpack": n, "pooled_level_dq": 3 * n, "pooled_level_dkv": 3 * n}
    print("cog multilevel gradient launches " + json.dumps(launches))
    for name, count in launches.items():
        assert count == want.get(name, 0), (name, count, want.get(name, 0))
    res = dict(grad_s=grad_s, peak_mem_gib=peak, n_factors=len(out),
               grad_abs_max=max(gr.abs().max().item() for gr in out))
    print("cog multilevel gradient " + json.dumps(res))
    del model, base, lora, out
    return res, launches


def _cross_attn_library(attn, x, context):
    """Wan's text cross-attention as library calls, the expression the dense
    kernels replaced: the module's projections and q/k RMS norms, then f32
    scores over strided head views, their softmax, P in bf16 @ V and a
    strided relayout into the output projection."""
    import torch

    c = attn.c
    b, lq, _ = x.shape

    def heads(t):
        return t.reshape(b, t.shape[1], c.num_heads, c.head_dim).transpose(1, 2)

    q = heads(attn.norm_q(attn.to_q(x)))
    k = heads(attn.norm_k(attn.to_k(context)))
    v = heads(attn.to_v(context))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(c.head_dim)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return attn.to_out[0](torch.matmul(p, v).transpose(1, 2).reshape(b, lq, c.dim))


def check_wan_cross_attn(torch, dev, checks):
    """Phase 24: Wan's text cross-attention over its 512 text keys on the
    dense kernels, then the module whole against its library expression."""
    from blade_torch.kernels.block_sparse_attn import flash_attention
    from blade_torch.kernels.ref_attention import dense_attention_with_lse
    from blade_torch.models.layers import init_lecun_
    from blade_torch.models.wan_dit import WAN_14B, WAN_1_3B, WanCrossAttention
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2468, dev)
    record = _recorder(checks)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lk, d = 512, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # -- the dense forward (#1) at the 1.3B and 14B query counts --------------
    for h, length, heads in ((12, 32760, None), (40, 75600, 4)):
        q, k, v = randn(1, h, length, d), randn(1, h, lk, d), randn(1, h, lk, d)
        hs = slice(0, heads)
        _attn_check(torch, record, "dense_fwd",
                    f"cross-attn q [1,{h},{length},128] k,v [1,{h},512,128]",
                    lambda: flash_attention(q, k, v),
                    lambda: dense_attention_with_lse(q[:, hs], k[:, hs], v[:, hs]), 20, 1,
                    False, *_dense_work(q, k, v), library=lambda: sdpa(q, k, v),
                    heads=heads)
        del q, k, v

    # -- the dense backward pair (#5/#6) at 1.3B ------------------------------
    q, k, v = randn(1, 12, 32760, d), randn(1, 12, lk, d), randn(1, 12, lk, d)
    _bwd_check(torch, record, gen, "dense", "cross-attn q,dO [1,12,32760,128] k,v [1,12,512,128]",
               q, k, v, None, 0.0, reps=10,
               library=lambda g: _dense_bwd_library(torch, q, k, v, g, 1.0 / math.sqrt(d)))
    del q, k, v
    torch.cuda.empty_cache()

    # -- the module whole, against its library expression, in turns ----------
    res = {}
    for name, cfg, length in (("wan", WAN_1_3B, 32760), ("wan14b", WAN_14B, 75600)):
        attn = WanCrossAttention(cfg, torch.bfloat16)
        with torch.no_grad():
            init_lecun_(attn, torch.Generator().manual_seed(5))
        attn = attn.to(dev)
        x, context = randn(1, length, cfg.dim), randn(1, lk, cfg.dim)
        with torch.no_grad():
            got, want = attn(x, context), _cross_attn_library(attn, x, context)
            err, ref_max = _max_err(got, want), want.float().abs().max().item()
            fwd_ms, lib_ms = _cuda_ms_turns(
                torch, [lambda: attn(x, context), lambda: _cross_attn_library(attn, x, context)],
                10)
        assert err <= OUT_REL * ref_max, (name, err, ref_max)
        res[name] = dict(fwd_ms=fwd_ms, library_fwd_ms=lib_ms, max_abs_err=err,
                         ref_max=ref_max)
        if cfg is WAN_1_3B:
            x.requires_grad_(True)
            g_out = randn(1, length, cfg.dim)
            wrt = [x, *attn.parameters()]
            res[name]["fwd_bwd_ms"], res[name]["library_fwd_bwd_ms"] = _cuda_ms_turns(torch, [
                lambda: torch.autograd.grad(attn(x, context), wrt, g_out),
                lambda: torch.autograd.grad(_cross_attn_library(attn, x, context), wrt, g_out)],
                5)
        print(f"cross_attn module {name} [1,{length},{cfg.dim}] x 512 text keys: "
              + json.dumps(res[name]))
        del attn, x, context, got, want
        torch.cuda.empty_cache()
    return res


def _bf16_ulp_ok(torch, got, want):
    """(ok, max |err|): every element within one bf16 ulp at its row's
    largest value (a LayerNorm's sums in another order can turn one
    rounding)."""
    g, w = got.float(), want.float()
    top = torch.maximum(g.abs(), w.abs()).amax(-1, keepdim=True).clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    err = (g - w).abs()
    return bool((err <= ulp).all()), err.max().item()


def check_wan_modulate(torch, dev, checks):
    """Phase 26: Wan's block glue (``csrc/adaln.cu``) at the 1.3B's and the
    14B's rows: ``norm_affine`` (the modulation's per-sample tables; library
    ``F.layer_norm`` with its own affine, in turns), ``add_norm_affine``
    (the gated residual and the cross-attention LayerNorm; no one library
    call), ``gated_add`` (library ``torch.addcmul``, in turns), each
    against its plain version; then one block's glue whole, the four calls
    a block makes, in turns with the expression they replaced."""
    import torch.nn.functional as F

    from blade_torch.kernels import adaln

    gen = torch.Generator(device=dev).manual_seed(2626)
    record = _recorder(checks)
    eps, res = 1e-6, {}
    for name, length, dim in (("wan", 32760, 1536), ("wan14b", 75600, 5120)):
        main = name == "wan14b"

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        x, y, y2 = randn(1, length, dim), randn(1, length, dim), randn(1, length, dim)
        e = 0.5 * torch.randn((1, 6, dim), generator=gen, device=dev)
        shift1, scale1, gate1, shift2, scale2, gate2 = e.unbind(1)
        w1 = 1 + scale1
        nw = 1.0 + 0.2 * torch.randn(dim, generator=gen, device=dev)
        nb = 0.1 * torch.randn(dim, generator=gen, device=dev)
        shape = f"x [1,{length},{dim}]"
        tables = _nbytes(w1, shift1)

        got = adaln.norm_affine(x, w1, shift1, eps)
        ok, err = _bf16_ulp_ok(torch, got, adaln.norm_affine_reference(x, w1, shift1, eps))
        ms, lib_ms = _cuda_ms_turns(torch, [
            lambda: adaln.norm_affine(x, w1, shift1, eps),
            lambda: F.layer_norm(x, (dim,), nw.to(torch.bfloat16), nb.to(torch.bfloat16), eps)],
            50)
        plain_ms = _cuda_ms(torch, lambda: adaln.norm_affine_reference(x, w1, shift1, eps), 10)
        record("norm_affine", shape + " -> h", ok, err, ms, plain_ms, "1 bf16 ulp of the row",
               main, 0.0, _nbytes(x, got) + tables, library_ms=lib_ms,
               library_call="F.layer_norm, bf16, its own affine")

        xo, h = adaln.add_norm_affine(x, y, gate1, nw, nb, eps)
        want_x, want_h = adaln.add_norm_affine_reference(x, y, gate1, nw, nb, eps)
        ok, err = _bf16_ulp_ok(torch, h, want_h)
        ok = ok and torch.equal(xo, want_x)
        ms = _cuda_ms(torch, lambda: adaln.add_norm_affine(x, y, gate1, nw, nb, eps), 50)
        plain_ms = _cuda_ms(
            torch, lambda: adaln.add_norm_affine_reference(x, y, gate1, nw, nb, eps), 10)
        record("add_norm_affine", shape + " y, gate -> x', h", ok, err, ms, plain_ms,
               "x' exact, h 1 bf16 ulp of the row", main, 0.0,
               _nbytes(x, y, xo, h, gate1, nw, nb))

        out = adaln.gated_add(x, y2, gate2)
        want = adaln.gated_add_reference(x, y2, gate2)
        ok, err = torch.equal(out, want), _max_err(out, want)
        g16 = gate2.to(torch.bfloat16)
        ms, lib_ms = _cuda_ms_turns(torch, [lambda: adaln.gated_add(x, y2, gate2),
                                            lambda: torch.addcmul(x, g16, y2)], 50)
        plain_ms = _cuda_ms(torch, lambda: adaln.gated_add_reference(x, y2, gate2), 10)
        record("gated_add", shape + " y, gate -> x'", ok, err, ms, plain_ms, "exact", main,
               0.0, _nbytes(x, y2, out, gate2), library_ms=lib_ms,
               library_call="torch.addcmul, bf16")

        # One block's glue as the block runs it, in turns with the expression.
        def glue(norm, add_norm, gated):
            hh = norm(x, 1 + scale1, shift1, eps)
            xx, n = add_norm(x, y, gate1, nw, nb, eps)
            xx, hh = add_norm(xx, n, None, 1 + scale2, shift2, eps)
            return gated(xx, hh, gate2)

        fused = (adaln.norm_affine, adaln.add_norm_affine, adaln.gated_add)
        plain = (adaln.norm_affine_reference, adaln.add_norm_affine_reference,
                 adaln.gated_add_reference)
        fused_ms, plain_ms = _cuda_ms_turns(torch, [lambda: glue(*fused),
                                                    lambda: glue(*plain)], 10)
        bound_ms, _ = _bound(0.0, 26 * length * dim)
        res[name] = dict(block_glue_ms=fused_ms, expression_ms=plain_ms,
                         bound_ms=bound_ms)
        print(f"block glue {name} [1,{length},{dim}] (4 kernels, 26 bytes an element): "
              + json.dumps(res[name]))
        del x, y, y2, got, xo, h, want_x, want_h, out, want
        torch.cuda.empty_cache()
    return res


def check_wan_i2v_kernels(torch, dev, checks):
    """Phase 25, first half: the kernels of the I2V 480p path at its 40
    heads over 32,760 tokens, each against its plain version (f32) on every
    head -- #1 over the 257 image keys (the last key tile holds one key),
    the energy lane's predictor and pooled branch (#1), its sparse rows (#2)
    on the mask of the preset's own predictor, and ``pack_kv`` (#3) over the
    32,760 keys (a ragged last block)."""
    from blade_torch import config as C
    from blade_torch.attention import asa
    from blade_torch.kernels.block_sparse_attn import (
        block_sparse_attention, flash_attention, flash_attention_wide_v)
    from blade_torch.kernels.pack import _pack_kv_reference, pack_kv
    from blade_torch.kernels.ref_attention import (
        block_masked_attention, dense_attention_with_lse)
    from blade_torch.utils.rng import make_generator

    gen = make_generator(2580, dev)
    record = _recorder(checks)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    preset = C.WAN_I2V_480P
    cfg = C.derive_asa_config(preset)
    h, d = preset.dit.num_heads, preset.dit.head_dim
    L, li = math.prod(preset.latent_grid()), preset.dit.image_context_tokens
    assert (h, d, L, li) == (40, 128, 32760, 257)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = randn(1, h, L, d), randn(1, h, L, d), randn(1, h, L, d)
    ki, vi = randn(1, h, li, d), randn(1, h, li, d)
    _attn_check(torch, record, "dense_fwd", f"image branch q [1,{h},{L},128] k,v [1,{h},257,128]",
                lambda: flash_attention(q, ki, vi),
                lambda: dense_attention_with_lse(q, ki, vi), 20, 1, False,
                *_dense_work(q, ki, vi), library=lambda: sdpa(q, ki, vi))
    del ki, vi

    tokens, n_kt = cfg.sample_tokens_per_block, -(-L // 128)
    ls = n_kt * tokens
    qs, ks = randn(1, h, ls, d), randn(1, h, ls, d)
    pool = torch.nn.functional.one_hot(torch.arange(ls, device=dev) // tokens, n_kt)
    pool = pool.to(torch.bfloat16).expand(1, h, ls, n_kt).contiguous()
    _attn_check(torch, record, "dense_fwd",
                f"predictor q,k [1,{h},{ls},128] v [1,{h},{ls},{n_kt}]",
                lambda: flash_attention_wide_v(qs, ks, pool),
                lambda: dense_attention_with_lse(qs, ks, pool), 20, 1, False,
                *_dense_work(qs, ks, pool), library=lambda: sdpa(qs, ks, pool))
    del qs, ks, pool
    gap = cfg.sample_gap
    kp = k.float().reshape(1, h, -1, gap, d).mean(3).to(torch.bfloat16)
    vp = v.float().reshape(1, h, -1, gap, d).mean(3).to(torch.bfloat16)
    _attn_check(torch, record, "dense_fwd",
                f"pooled q [1,{h},{L},128] k,v [1,{h},{L // gap},128]",
                lambda: flash_attention(q, kp, vp, bias=math.log(gap)),
                lambda: dense_attention_with_lse(q, kp, vp, bias=math.log(gap)), 20, 1, False,
                *_dense_work(q, kp, vp), library=lambda: sdpa(q, kp, vp))
    del kp, vp

    # The token mask of the masked-SDPA library call would take 86 GB at 40
    # heads: the sparse rows are held and timed without it.
    mask = asa.compute_mask(q, k, cfg, generator=make_generator(7, dev))
    density = mask.float().mean().item()
    _attn_check(torch, record, "sparse_fwd", f"q,k,v [1,{h},{L},128] density {density:.4f} "
                f"{_row_blocks(mask)}",
                lambda: block_sparse_attention(q, k, v, mask),
                lambda: block_masked_attention(q, k, v, mask, block_k=128), 10, 1, False,
                4.0 * d * _block_pairs(mask, L, L), _nbytes(q, k, v, mask))

    kf, vf = k.view(h, L, d), v.view(h, L, d)
    got, want = pack_kv(kf, vf), _pack_kv_reference(kf, vf)
    record("pack_kv", f"k,v [{h},{L},128] -> [{h},{got.shape[1]},128]",
           torch.equal(got, want), _max_err(got, want),
           _cuda_ms(torch, lambda: pack_kv(kf, vf), 50),
           _cuda_ms(torch, lambda: _pack_kv_reference(kf, vf), 50), "bit exact", False,
           0.0, _nbytes(kf, vf, got))
    del q, k, v, mask, kf, vf, got, want
    torch.cuda.empty_cache()
    return density


def serve_wan_i2v(torch, dev):
    """Phase 25: one full-width, full-depth Wan2.1-I2V-14B 480p request
    (encode, 8 steps, decode) under a CPU profiler, with exact launch counts
    and the image branch's counter."""
    from torch.profiler import ProfilerActivity, profile

    from blade_torch.cli.inference import (
        build_pipeline,
        get_args,
        image_inputs,
        random_text_embeds,
    )
    from blade_torch.kernels._build import KERNELS, reset_launch_counts
    from blade_torch.utils import tracing
    from blade_torch.utils.rng import make_generator

    args = get_args(["--preset", "wan-i2v-14b-480p", "--random-init", "--seed", "8888",
                     "--steps", "8"])
    t0 = time.perf_counter()
    pipe = build_pipeline(args)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.dit.parameters())
    print(f"wan i2v pipeline built in {time.perf_counter() - t0:.2f} s; DiT params "
          f"{n_params / 1e9:.3f} B; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    c = pipe.preset.dit
    assert (c.num_layers, c.dim, c.in_channels, c.image_dim) == (40, 5120, 36, 1280)
    text = random_text_embeds(pipe, "a corgi surfing a wave at sunset")
    image, feats = image_inputs(pipe, None, args.seed)
    assert image.shape == (1, 3, 480, 832) and feats.shape == (1, 257, 1280)
    tracing.reset()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        frames = pipe.generate(text, generator=make_generator(args.seed, dev),
                               num_steps=args.steps, image=image, image_embeds=feats)
        u8 = pipe.frames_to_uint8(frames)
        torch.cuda.synchronize()
    clip_s = time.perf_counter() - t
    counters = tracing.counters()
    tracing.reset()
    launches = {name: k.launches for name, k in KERNELS.items()}
    assert u8.shape == (1, 81, 480, 832, 3) and torch.isfinite(frames).all()
    n = c.num_layers * args.steps
    want = {"dense_fwd": 4 * n, "sparse_fwd": n, "pack_kv": n, "norm_rope": 2 * n,
            "heads_pack": 5 * n, "heads_unpack": n, **_glue_launches(c.num_layers, args.steps)}
    for name, count in launches.items():
        assert count == want.get(name, 0), (name, count, want.get(name, 0))
    assert counters["dit.cross_attn.image_calls"] == counters["dit.cross_attn.calls"] == n
    assert counters["dit.modulate.fused_calls"] == n, counters
    assert "dit.modulate.autograd_calls" not in counters, counters
    result = dict(clip_s=clip_s, encode_s=counters["encode.seconds"],
                  sample_s=counters["sample.seconds"], decode_s=counters["decode.seconds"],
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  image_calls=counters["dit.cross_attn.image_calls"],
                  frames_mean=float(u8.float().mean()))
    print("wan i2v request (cold, CPU profiler on) " + json.dumps(result))
    print("launches over the i2v request " + json.dumps(launches))
    del pipe
    return result, launches


def _tdm_forwards(k_step, cfg, lambda_reg):
    """DiT forwards a TDM step runs with remat: the k_step trajectory, the
    student's x0, the teacher's x0 when lambda_reg > 0, the fake and the
    generator forwards with gradient (each recomputed in its backward), the
    teacher's guided prediction (two forwards with CFG) and the fake's."""
    return k_step + 1 + (lambda_reg > 0) + 2 * 2 + (2 if cfg != 1.0 else 1) + 1


def train_cog(torch, dev):
    """Phase 23, the CogVideoX training path: ``blade_torch.cli.train.main``
    at full width (``cogvideox-5b-480p``, 42 blocks, 48 heads of 64, 17776
    tokens with the 226 text tokens, random weights, ASA energy lane, remat,
    the DDPM family), three TDM steps at the CLI defaults; exact launch
    counts a step at d = 64."""
    import tempfile

    from blade_torch.cli import train as cli
    from blade_torch.kernels._build import KERNELS, reset_launch_counts

    argv = ["--family", "cogvideox", "--random-init", "--batch_size", "1", "--k_step", "2",
            "--max_train_steps", "3", "--seed", "42"]
    args = cli.get_args(argv + ["--output_dir", "unused"])
    per_step = []

    def on_step(rec, state):
        per_step.append({name: k.launches for name, k in KERNELS.items()})
        reset_launch_counts()

    with tempfile.TemporaryDirectory(prefix="blade_torch_train_cog_") as out:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        state, history = cli.main(argv + ["--output_dir", out], on_step=on_step)
        peak = torch.cuda.max_memory_allocated()
        assert os.path.exists(os.path.join(out, "tdm_lora.npz"))
    assert len(history) == 3 and state.step == 3
    for rec in history:
        assert math.isfinite(rec["loss_fake"]) and math.isfinite(rec["loss_du"]), rec
        assert not rec["fake_skipped"], rec  # no fake-loss guard for CogVideoX
    layers = 42
    fwd = _tdm_forwards(args.k_step, args.cfg, args.lambda_reg) * layers
    want = {"dense_fwd": 2 * fwd, "sparse_fwd": fwd, "pack_kv": fwd, "qk_norm_rope": fwd,
            "heads_pack": fwd, "dense_dq": 2 * layers, "dense_dkv": 2 * layers,
            "sparse_dq": 2 * layers, "sparse_dkv": 2 * layers, "attn_delta": 4 * layers,
            "qk_norm_rope_dx": 2 * layers, "heads_unpack": 2 * layers}
    for i, counts in enumerate(per_step):
        print(f"train_cog step {i} launches " + json.dumps(counts))
        for name, count in counts.items():
            assert count == want.get(name, 0), (i, name, count, want.get(name, 0))
    moved_g = sum(state.lora_g[k].abs().sum().item() for k in state.lora_g if k.endswith(".b"))
    moved_f = sum(state.lora_f[k].abs().sum().item() for k in state.lora_f if k.endswith(".b"))
    assert moved_g > 0 and moved_f > 0, (moved_g, moved_f)
    assert not any("attn2" in k for k in state.lora_g)
    fresh = cli.build_model(args, cli.build_preset(args), dev)
    assert all(torch.equal(p, state.base[n]) for n, p in fresh.named_parameters()), \
        "the frozen base changed"
    del fresh
    warm = [r["step_s"] for r in history[1:]]
    res = dict(s_per_step_warm=sum(warm) / len(warm), step_s=[r["step_s"] for r in history],
               loss_fake=[r["loss_fake"] for r in history],
               loss_du=[r["loss_du"] for r in history], peak_mem_gib=peak / 2**30,
               lora_g_b_abs_sum=moved_g, lora_f_b_abs_sum=moved_f,
               forwards_a_step=fwd // layers)
    print("train_cog " + json.dumps(res))
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
    t_start = time.perf_counter()
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
    grad_err = gradient_check(torch, dev)
    trained, train_launches = train(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    check_cog_multilevel(torch, dev, checks)
    check_dense_d64(torch, dev, checks)
    check_cog_qk(torch, dev, checks)
    cog_results, cog_launches, cog_dense_ms = serve_cog(torch, dev)
    cog_ref_err = cog_reference_check(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    lane_ms, dense_attn_ms = check_wan14b_pooled(torch, dev, checks)
    gc.collect()
    torch.cuda.empty_cache()
    carry = check_wan14b_carry(torch, dev, checks)
    gc.collect()
    torch.cuda.empty_cache()
    w14_results, w14_launches, w14_dense_ms, w14_params = serve_wan14b(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    w14_ref_err, w14_grad_err = wan14b_reference_check(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    check_last_kernels(torch, dev, checks)
    gc.collect()
    torch.cuda.empty_cache()
    max_results, max_launches, max_density, max_ref_err = serve_maxpred(torch, dev, results[1])
    gc.collect()
    torch.cuda.empty_cache()
    union_results, union_launches, stock_density = serve_union(torch, dev, results[1])
    gc.collect()
    torch.cuda.empty_cache()
    cog_energy_density = check_cog_energy(torch, dev, checks)
    gc.collect()
    torch.cuda.empty_cache()
    lanes = check_multilevel_backward(torch, dev, checks)
    gc.collect()
    torch.cuda.empty_cache()
    block_glue = check_wan_modulate(torch, dev, checks)
    assert set(checks) == set(_build.KERNELS), (set(checks), set(_build.KERNELS))
    gc.collect()
    torch.cuda.empty_cache()
    cog_grad_err = multilevel_gradient_check(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    cog_grad, cog_grad_launches = cog_multilevel_gradient(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    trained_cog, train_cog_launches = train_cog(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    cross_attn = check_wan_cross_attn(torch, dev, checks)
    gc.collect()
    torch.cuda.empty_cache()
    i2v_density = check_wan_i2v_kernels(torch, dev, checks)
    gc.collect()
    torch.cuda.empty_cache()
    i2v, i2v_launches = serve_wan_i2v(torch, dev)

    warm, cog, w14 = results[1], cog_results[1], w14_results[0]
    print("summary " + json.dumps(dict(
        card=smi, denoise_s=warm["denoise_s"], step_ms=warm["step_ms"],
        decode_s=warm["decode_s"], clip_s=warm["clip_s"], dense_step_ms=dense_ms,
        cold_clip_s=results[0]["clip_s"], peak_mem_gib=max(r["peak_mem_gib"] for r in results),
        denoise_peak_gib=warm["denoise_peak_gib"], decode_peak_gib=warm["decode_peak_gib"],
        reference_max_abs_err=ref_err,
        gradient_max_abs_err=grad_err, train_s_per_step=trained["s_per_step_warm"],
        train_peak_mem_gib=trained["peak_mem_gib"],
        cog_clip_s=cog["clip_s"], cog_denoise_s=cog["denoise_s"], cog_step_ms=cog["step_ms"],
        cog_decode_s=cog["decode_s"], cog_dense_step_ms=cog_dense_ms,
        cog_peak_mem_gib=max(r["peak_mem_gib"] for r in cog_results),
        cog_cold_clip_s=cog_results[0]["clip_s"], cog_reference_max_abs_err=cog_ref_err,
        wan14b_clip_s=w14["clip_s"], wan14b_denoise_s=w14["denoise_s"],
        wan14b_step_ms=w14["step_ms"], wan14b_decode_s=w14["decode_s"],
        wan14b_dense_step_ms=w14_dense_ms, wan14b_peak_mem_gib=w14["peak_mem_gib"],
        wan14b_denoise_peak_gib=w14["denoise_peak_gib"],
        wan14b_decode_peak_gib=w14["decode_peak_gib"], wan14b_params_b=w14_params / 1e9,
        wan14b_attention_lane_ms=lane_ms, wan14b_attention_dense_ms=dense_attn_ms,
        wan14b_carry_ms=carry["carry_ms"], wan14b_per_level_ms=carry["per_level_ms"],
        wan14b_lists_ms=carry["lists_ms"],
        wan14b_reference_max_abs_err=w14_ref_err, wan14b_gradient_max_abs_err=w14_grad_err,
        maxpred_step_ms=max_results[1]["step_ms"], maxpred_clip_s=max_results[1]["clip_s"],
        maxpred_denoise_s=max_results[1]["denoise_s"],
        maxpred_decode_s=max_results[1]["decode_s"],
        maxpred_cold_clip_s=max_results[0]["clip_s"], maxpred_density=max_density,
        maxpred_reference_max_abs_err=max_ref_err, union_step_ms=union_results[0]["step_ms"],
        union_clip_s=union_results[0]["clip_s"], stock_density=stock_density,
        cog_energy_density=cog_energy_density,
        cog_lane_fwd_ms=lanes["cog_fused"]["fwd_ms"],
        cog_lane_bwd_ms=lanes["cog_fused"]["bwd_ms"],
        wan14b_lane_fwd_ms=lanes["wan14b_per_level"]["fwd_ms"],
        wan14b_lane_bwd_ms=lanes["wan14b_per_level"]["bwd_ms"],
        wan14b_carry_fwd_ms=lanes["wan14b_carry"]["fwd_ms"],
        wan14b_carry_bwd_ms=lanes["wan14b_carry"]["bwd_ms"],
        cog_gradient_max_abs_err=cog_grad_err,
        cog_multilevel_grad_s=cog_grad["grad_s"],
        cog_multilevel_grad_peak_mem_gib=cog_grad["peak_mem_gib"],
        train_cog_s_per_step=trained_cog["s_per_step_warm"],
        train_cog_peak_mem_gib=trained_cog["peak_mem_gib"],
        cross_attn_ms={name: r["fwd_ms"] for name, r in cross_attn.items()},
        cross_attn_library_ms={name: r["library_fwd_ms"] for name, r in cross_attn.items()},
        i2v_clip_s=i2v["clip_s"], i2v_encode_s=i2v["encode_s"],
        i2v_peak_mem_gib=i2v["peak_mem_gib"], i2v_kernel_check_density=i2v_density,
        block_glue_ms={name: r["block_glue_ms"] for name, r in block_glue.items()},
        block_glue_expression_ms={name: r["expression_ms"] for name, r in block_glue.items()},
        wall_s=time.perf_counter() - t_start)))
    paths = {"serve_wan": serve_launches, "train_wan": train_launches,
             "serve_cog": cog_launches, "serve_wan14b": w14_launches,
             "serve_wan_maxpred": max_launches, "serve_wan_union": union_launches,
             "grad_cog_multilevel": cog_grad_launches, "train_cog": train_cog_launches,
             "serve_wan_i2v": i2v_launches}
    kernels = []
    for name, k in _build.KERNELS.items():
        main_check = next(c for c in checks[name] if c["main"])
        kernels.append(dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=sum(p[name] for p in paths.values()),
            launches_by_path={path: p[name] for path, p in paths.items()},
            max_abs_err=max(c["max_abs_err"] for c in checks[name]),
            ms=main_check["ms"], plain_ms=main_check["plain_ms"],
            bound_ms=main_check["bound_ms"], bound_by=main_check["bound_by"],
            library_ms=main_check["library_ms"], library_call=main_check["library_call"],
            shape=main_check["shape"], checks=checks[name]))
    print(json.dumps({"kernels": kernels}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
