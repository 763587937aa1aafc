"""The harness on the CPU: the registry, the last line, the window."""

import json
import time

import pytest

from bench_torch.harness.cell import closed_loop


def test_last_line_end_to_end(tiny_root, run_tiny):
    result, err = run_tiny(tiny_root, "wan-tiny.t2v", trace=0)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"clip_s", "peak_mem_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert set(result["checks"]) == {"velocity_rel_err", "latents_rel_err", "frames_mae"}
    # every number compared, beside its limit, as the last lines of stderr
    tail = err.strip().splitlines()[-4:]
    assert [line.split()[1] for line in tail[:3]] == list(result["checks"])
    assert tail[-1] == "correct True"


def test_last_line_per_layer(tiny_root, run_tiny):
    result, _ = run_tiny(tiny_root, "cogvideox-tiny.t2v", trace=1)
    assert list(result)[-1] == "checks" and "breakdown" in result
    # no device ran on the CPU: the device readers find nothing and say nothing
    assert set(result["metrics"]) == {"denoise_s", "decode_s", "denoise_mfu", "density.t2v"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_parts_found_from_files_alone(tiny_root, run_tiny):
    """A configuration, a traffic mix and a per-layer metric added as files
    and entries, with no file of the harness edited."""
    (tiny_root / "traffic" / "t2v-2step.json").write_text(json.dumps(
        {"driver": "t2v", "num_steps": 2, "mask_refresh_every": 0}))
    cfg = json.loads((tiny_root / "configs" / "wan-tiny.json").read_text())
    cfg["name"] = "wan-tiny-copy"
    (tiny_root / "configs" / "wan-tiny-copy.json").write_text(json.dumps(cfg))
    (tiny_root / "limits" / "wan-tiny-copy.t2v-2step.json").write_text(
        (tiny_root / "limits" / "wan-tiny.t2v.json").read_text())
    (tiny_root / "metrics" / "forwards_a_clip.py").write_text(
        "def read(records):\n    return records['forwards'] / records['units']\n")
    bench_path = tiny_root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "wan-tiny-copy.t2v-2step", "config": "wan-tiny-copy",
                               "traffic": "t2v-2step", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "forwards_a_clip", "unit": "1", "better": "lower",
                               "source": "program_counter", "layer": "sampler",
                               "moves": "clip_s", "workloads": ["wan-tiny-copy.t2v-2step"]})
    bench_path.write_text(json.dumps(bench))
    result, _ = run_tiny(tiny_root, "wan-tiny-copy.t2v-2step", trace=1)
    assert result["correct"] is True
    assert result["metrics"]["forwards_a_clip"] == {"value": 2.0, "unit": "1"}


def test_window_counts_whole_units():
    done = []

    def issue(i):
        time.sleep(0.03)
        done.append(i)

    window, attempted, failed = closed_loop(issue, 0.07)
    assert (attempted, failed, done) == (3, 0, [0, 1, 2])
    assert window >= 0.09  # from the first issue to the last completion
    assert window / attempted == pytest.approx(0.03, rel=0.5)


def test_window_stops_at_a_failed_unit():
    def issue(i):
        if i == 1:
            raise RuntimeError("unit failed")

    _, attempted, failed = closed_loop(issue, 10.0)
    assert (attempted, failed) == (2, 1)


def test_last_line_of_a_training_cell(tiny_root, run_tiny):
    result, err = run_tiny(tiny_root, "wan-tiny.tdm", trace=0)
    assert result["correct"] is True and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_step_s", "peak_mem_gib", "setup_s"}
    assert set(result["checks"]) == {"loss_rel_err", "grad_norm_gap", "change_median_gap"}
    assert err.strip().splitlines()[-1] == "correct True"
    result, _ = run_tiny(tiny_root, "cogvideox-tiny.tdm", trace=1)
    assert result["correct"] is True
    # no device ran on the CPU: the device readers find nothing and say nothing
    assert set(result["metrics"]) == {"train_mfu", "density.tdm"}


def test_a_traffic_key_no_driver_reads_is_refused(tiny_root, run_tiny):
    path = tiny_root / "traffic" / "t2v.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps(dict(mix, batch=2)))
    with pytest.raises(ValueError, match="batch"):
        run_tiny(tiny_root, "wan-tiny.t2v")
