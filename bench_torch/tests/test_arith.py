"""The yardstick's arithmetic against hand counts, and the reduction of a
synthetic trace."""

import json
import math

import pytest
import torch

from bench_torch.harness import roofline
from bench_torch.harness.trace import kernel_group, reduce_trace
from bench_torch.reference import cogvideox, wan
from conftest import REPO


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e9, 3.35e12) == pytest.approx(1.0)


def test_block_pairs_leave_out_the_ragged_tail():
    mask = torch.tensor([[True, False, True], [False, False, True], [True, True, False]])
    # lq = lk = 300: blocks of 128, 128 and 44 rows and keys
    want = 128 * 128 + 128 * 44 + 128 * 44 + 44 * 128 + 44 * 128
    assert float(roofline.block_pairs(mask, 300, 300)) == want


def test_energy_work_by_hand():
    mask = torch.ones((1, 2, 2, 2), dtype=torch.bool)
    lq = lk = 256
    flops, least = roofline.asa_energy_work(mask, lq, lk, head_dim=64, sample_tokens=16, gap=4)
    pairs = 2 * 256 * 256  # every pair, 2 heads
    pooled = 2 * 256 * 64  # every query, 64 pooled keys
    predictor = 2 * 2 * 32 * 32 * 64  # 2 heads, 32 sampled rows x 32 sampled keys
    assert float(flops) == 4 * 64 * (pairs + pooled) + predictor
    nbytes = 2 * 2 * 64 * (2 * 256 + 2 * 256)
    assert float(least) == pytest.approx(max(float(flops) / 989e12, nbytes / 3.35e12))


def test_level_pairs_by_hand():
    # one head, one 256-row mask row over lq = 300, lk = 300 keys (3 blocks):
    # level 2 lists blocks 0 and 2 -> 64 + ceil(300 / 2) - 128 = 64 + 22 keys
    idx = torch.tensor([[[[0, 2, 2]]]])
    cnt = torch.tensor([[[2]]])
    assert float(roofline.level_pairs(idx[0], cnt[0], 300, 300, 2, 256)) == 256 * (64 + 22)


def test_levels_to_lists():
    levels = torch.tensor([[1, 0, 2, 1]])
    idx, cnt = roofline.levels_to_lists(levels)
    assert cnt.tolist() == [[2, 1, 0, 0]]
    assert idx[0, 0, :2].tolist() == [0, 3] and idx[0, 1, :1].tolist() == [2]


def test_wan_dense_flops_by_hand():
    c = json.loads((REPO / "bench_torch/configs/wan2.1-t2v-1.3b-480p.json").read_text())
    L, lt, d, f = 32760, 512, 1536, 8960
    layer = 2 * (6 * L * d * d + 2 * lt * d * d + 2 * L * d * f) + 4 * L * lt * d
    embed = 2 * (L * 64 * d + lt * 4096 * d + lt * d * d + 256 * d + d * d + 6 * d * d
                 + L * d * 64)
    assert wan.dense_flops(c, L) == pytest.approx(30 * layer + embed, rel=1e-12)
    # one step of the 480p clip: 8.2e13 in the projections, 3.1e12 across
    assert 8.4e13 < wan.dense_flops(c, L) < 8.6e13


def test_cogvideox_dense_flops_by_hand():
    c = json.loads((REPO / "bench_torch/configs/cogvideox-5b-480p.json").read_text())
    L, lt, d, te = 17550, 226, 3072, 512
    j = L + lt
    layer = 2 * (4 * j * d * d + 2 * j * d * 4 * d + 2 * te * 6 * d)
    embed = 2 * (L * 64 * d + lt * 4096 * d + d * te + te * te + te * 2 * d + L * d * 64)
    assert cogvideox.dense_flops(c, L) == pytest.approx(42 * layer + embed, rel=1e-12)


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def test_trace_reduction_on_a_synthetic_trace():
    events = [
        _x("bench.window", "user_annotation", 0, 100),
        _x("bench.dit", "user_annotation", 5, 40),
        _x("bench.asa", "user_annotation", 10, 10),
        _x("bench.decode", "user_annotation", 60, 35),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 30, 1, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 62, 1, correlation=3),
        _x("void gather_fwd_kernel<128, ListsWalk<128, 128, 1> >(GatherArgs)", "kernel",
           14, 10, correlation=1),
        _x("ampere_bf16_s16816gemm_bf16_128x128", "kernel", 20, 20, correlation=2),
        _x("cudnn::conv_fprop", "kernel", 70, 10, correlation=3),
    ]
    r = reduce_trace(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(36e-6)  # [14, 40] and [70, 80]
    assert r["span_device_s"]["asa"] == pytest.approx(10e-6)
    assert r["span_device_s"]["dit"] == pytest.approx(30e-6)
    assert r["span_device_s"]["decode"] == pytest.approx(10e-6)
    assert r["device_ops"][0] == ["gemm (cuBLAS/CUTLASS)", pytest.approx(20e-6)]
    # the longest gap, [40, 70], began while the host was in bench.dit
    assert r["idle_gaps"][0] == ["dit", pytest.approx(30e-6)]
    assert set(r["span_device_s"]) == {"dit", "asa", "decode"}
    # the idle share's reader: 64 of the window's 100 us ran nothing
    from bench_torch.harness.registry import Registry

    reader = Registry().module("metrics", "idle_share.t2v")
    assert reader.read({"trace": r}) == pytest.approx(64.0)


@pytest.mark.parametrize("name, group", [
    ("void gather_fwd_kernel<128, ListsWalk<128, 128, 4> >(GatherArgs)", "gather_fwd_kernel"),
    ("void dense_fwd_kernel<128, false>(CUtensorMap, CUtensorMap)", "dense_fwd_kernel"),
    ("void pooled_dq_kernel<64>(bf16 const*)", "pooled_dq_kernel"),
    ("void dq_kernel<128>(CUtensorMap)", "dq_kernel"),
    ("norm_rope_kernel", "norm_rope_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm (cuBLAS/CUTLASS)"),
    ("Memcpy DtoH (Device -> Pageable)", "copy / cat / index"),
])
def test_kernel_groups_use_the_port_names(name, group):
    assert kernel_group(name) == group


def test_port_kernel_names_are_read_from_the_sources():
    from bench_torch.harness.trace import port_kernel_names

    names = port_kernel_names()
    for k in ("dense_fwd_kernel", "gather_fwd_kernel", "dq_kernel", "dkv_kernel",
              "delta_kernel", "pooled_scores_kernel", "pooled_dq_kernel", "pooled_dkv_kernel",
              "norm_rope_kernel", "pack_kv_kernel", "pack_kv_pyramid_kernel"):
        assert k in names
    assert math.isfinite(len(names))


def test_energy_backward_work_by_hand():
    mask = torch.ones((1, 2, 2, 2), dtype=torch.bool)
    flops, least = roofline.asa_energy_backward_work(mask, 256, 256, head_dim=64, gap=4)
    pairs, pooled = 2 * 256 * 256, 2 * 256 * 64
    assert float(flops) == 2 * 4 * 64 * (pairs + pooled)  # no predictor
    nbytes = 2 * 2 * 64 * (4 * 256 + 4 * 256)
    assert float(least) == pytest.approx(max(float(flops) / 989e12, nbytes / 3.35e12))


def test_backward_flops_by_hand():
    c = json.loads((REPO / "bench_torch/configs/wan2.1-t2v-1.3b-480p.json").read_text())
    L, lt, d, f, r = 32760, 512, 1536, 8960, 64
    layer = (2 * (6 * L * d * d + 2 * lt * d * d + 2 * L * d * f) + 2 * 4 * L * lt * d
             + 4 * r * (6 * L * 2 * d + 2 * lt * 2 * d))
    assert wan.backward_flops(c, L, r) == pytest.approx(30 * layer + 2 * L * d * 64, rel=1e-12)
    c = json.loads((REPO / "bench_torch/configs/cogvideox-5b-480p.json").read_text())
    L, lt, d = 17550, 226, 3072
    j = L + lt
    layer = 2 * (4 * j * d * d + 2 * j * d * 4 * d) + 4 * 4 * j * r * 2 * d
    assert cogvideox.backward_flops(c, L, r) == pytest.approx(42 * layer + 2 * L * d * 64,
                                                              rel=1e-12)


def test_latent_shapes_match_the_presets():
    from blade_torch import config as C
    from blade_torch.cli.train import latent_shape

    for fam, name in ((wan, "wan2.1-t2v-1.3b-480p"), (cogvideox, "cogvideox-5b-480p")):
        c = json.loads((REPO / f"bench_torch/configs/{name}.json").read_text())
        assert fam.latent_shape(c) == latent_shape(C.PRESETS[c["preset"]], 1)


def test_backward_of_a_span_on_a_synthetic_trace():
    """Device time of the autograd nodes whose forward op ran inside a span
    goes to ``<span>.backward``; a forward recomputed in the backward stays
    under the span it opens."""
    node = "autograd::engine::evaluate_function: "
    events = [
        dict(_x("bench.window", "user_annotation", 0, 100), tid=1),
        dict(_x("bench.asa", "user_annotation", 10, 10), tid=1),
        dict(_x("_Attention", "cpu_op", 12, 2, **{"Sequence number": 5}), tid=1),
        dict(_x("aten::mm", "cpu_op", 30, 2, **{"Sequence number": 6}), tid=1),
        dict(_x(node + "MmBackward0", "cpu_op", 45, 4, **{"Sequence number": 6}), tid=2),
        dict(_x(node + "_AttentionBackward", "cpu_op", 50, 20, **{"Sequence number": 5}), tid=2),
        dict(_x("bench.asa", "user_annotation", 52, 3), tid=2),  # recomputed forward
        _x("cudaLaunchKernel", "cuda_runtime", 46, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 53, 1, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 60, 1, correlation=3),
        _x("sm90_xmma_gemm_bf16", "kernel", 47, 3, correlation=1),
        _x("void gather_fwd_kernel<64, ListsWalk<64, 128, 1> >(GatherArgs)", "kernel", 54, 4,
           correlation=2),
        _x("void dq_kernel<64>(CUtensorMap)", "kernel", 61, 8, correlation=3),
    ]
    r = reduce_trace(events)
    assert r["span_device_s"]["asa"] == pytest.approx(4e-6)
    assert r["span_device_s"]["asa.backward"] == pytest.approx(8e-6)
    from bench_torch.harness.registry import Registry

    reader = Registry().module("metrics", "attn_roofline.tdm")
    assert reader.read({"asa_bound_s": 6e-6, "trace": r}) == pytest.approx(50.0)


def test_train_mfu_reader():
    from bench_torch.harness.registry import Registry

    reader = Registry().module("metrics", "train_mfu")
    assert reader.read({"model_flops": {"train": 989e12}, "step_total_s": 4.0}) == 25.0
    assert reader.read({"step_total_s": 4.0}) is None
