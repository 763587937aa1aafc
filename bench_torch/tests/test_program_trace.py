"""The reduction by program spans (``harness/program_trace.py``) on a
hand-built Chrome trace, and ``reduce_trace`` unmoved by ``blade.*`` spans.

The trace (times in us): a window 0-1000 on thread 1; a clip
``blade.sample`` 10-500 holding ``blade.dit`` 20-320, which holds
``blade.asa`` 50-150; ``blade.decode`` 520-600; then a training step
``blade.tdm.step`` 620-990 holding ``blade.tdm.fake`` 630-900, which holds
``blade.sync`` 680-760.  Kernels, each launched 5 us before it starts:

    name                 launch   runs       launched inside
    gather_fwd_kernel    60       65-95      sample, dit, asa
    elementwise (asa)    100      105-135    sample, dit, asa
    gemm                 200      205-300    sample, dit
    elementwise          490      495-510    sample (ends past it)
    conv                 530      535-560    decode
    gemm                 640      645-690    tdm.step, tdm.fake
    copy                 770      775-800    tdm.step, tdm.fake
    dq_kernel            910      915-935    tdm.step

``dq_kernel`` is launched by an autograd node (thread 2, 900-950) whose
forward op ran inside ``blade.asa``.
"""

import copy

import pytest

from bench_torch.harness import program_trace as P
from bench_torch.harness import trace as T


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _kernel(name, launch, start, dur, corr):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
             "dur": 2, "tid": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur, "tid": 7,
             "args": {"correlation": corr}}]


def _events():
    ev = [_span("bench.window", 0, 1000), _span("bench.dit", 20, 300),
          _span("blade.sample", 10, 490), _span("blade.dit", 20, 300),
          _span("blade.asa", 50, 100), _span("blade.decode", 520, 80),
          _span("blade.tdm.step", 620, 370), _span("blade.tdm.fake", 630, 270),
          _span("blade.sync", 680, 80),
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 70, "dur": 5, "tid": 1,
           "args": {"Sequence number": 41}},
          {"ph": "X", "cat": "cpu_op", "name": T.NODE + "MmBackward0", "ts": 900, "dur": 50,
           "tid": 2, "args": {"Sequence number": 41}}]
    kernels = [("void gather_fwd_kernel<128, 128, 1>(Params)", 60, 65, 30),
               ("void at::native::vectorized_elementwise_kernel<4>()", 100, 105, 30),
               ("nvjet_tst_128x256_64x4", 200, 205, 95),
               ("void at::native::vectorized_elementwise_kernel<4>()", 490, 495, 15),
               ("cudnn_conv_fprop", 530, 535, 25),
               ("nvjet_tst_128x256_64x4", 640, 645, 45),
               ("void at::native::copy_kernel()", 770, 775, 25),
               ("void dq_kernel<64>(Params)", 910, 915, 20)]
    for corr, (name, launch, start, dur) in enumerate(kernels):
        ev += _kernel(name, launch, start, dur, corr)
    return ev


def test_device_time_is_credited_by_program_span():
    r = P.reduce_program_trace(_events())
    us = {k: round(v * 1e6, 6) for k, v in r["span_device_s"].items()}
    assert us["sample"] == 30 + 30 + 95 + 15
    assert us["dit"] == 30 + 30 + 95 and us["asa"] == 30 + 30
    assert us["decode"] == 25 and us["tdm.fake"] == 45 + 25 and us["tdm.step"] == 45 + 25 + 20
    assert us["sync"] == 0 and us["asa.backward"] == 20
    # ASA's device time: 30 us of the port's kernel and 20 of its backward
    # node's, 30 of a library kernel
    assert r["asa_glue_share"] == pytest.approx(100 * 30 / 80)
    assert r["window_s"] == pytest.approx(1000e-6)


def test_complete_time_runs_to_the_last_kernel_launched_inside_the_span():
    r = P.reduce_program_trace(_events())
    assert r["complete_s"]["sample"] == pytest.approx((510 - 10) * 1e-6)
    assert r["complete_s"]["decode"] == pytest.approx(80e-6)  # its kernel ends inside it
    assert r["spans"] == {"sample": 1, "decode": 1, "tdm.step": 1}


def test_idle_gaps_carry_the_innermost_program_span():
    r = P.reduce_program_trace(_events())
    # gaps: 0-65, 95-105, 135-205, 300-495, 510-535, 560-645, 690-775,
    # 800-915, 935-1000, each labelled where the host was at its start
    assert [[label, round(s * 1e6, 6)] for label, s in r["program_idle_gaps"]] == [
        ["dit", 195], ["tdm.fake", 115], ["decode", 85], ["sync", 85], ["asa", 70],
        ["outside every span", 65], ["tdm.step", 65], ["outside every span", 25],
        ["asa", 10]]
    assert sum(r["idle_s_by_span"].values()) == pytest.approx(r["window_s"] - r["busy_s"])
    assert r["idle_s_by_span"]["asa"] == pytest.approx(80e-6)
    # trainer idle: the gaps that open in a tdm.* or sync span outside every
    # blade.dit, over the one step
    assert r["trainer_idle_s"] == pytest.approx((85 + 115 + 65) * 1e-6)


def test_reduce_trace_reads_the_same_without_and_with_program_spans():
    with_spans = _events()
    without = [e for e in copy.deepcopy(with_spans)
               if not str(e.get("name", "")).startswith(P.PREFIX)]
    assert len(without) < len(with_spans)
    assert T.reduce_trace(with_spans) == T.reduce_trace(without)
