"""CPU fixtures of the benchmark's tests: a copy of the benchmark folder with
the tiny configurations (``data/``) added as cells, run on the CPU.

    JAX_PLATFORMS=cpu python -m pytest bench_torch/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# The full-size cell whose limits each tiny cell is held to.
LIMITS_OF = {"wan-tiny.t2v": "wan-1.3b-480p.t2v", "cogvideox-tiny.t2v": "cogvideox-5b-480p.t2v",
             "cogvideox-tiny.tdm": "cogvideox-5b-480p.tdm"}
# The full-size mix of each tiny configuration's training cell.
TDM_MIX = {"wan-tiny": "tdm-wan", "cogvideox-tiny": "tdm-cogvideox"}
# Tight limits for the tiny cells, which run in f32 on both sides.
TIGHT = {"t2v": {"check_steps": 2, "limits": {"velocity_rel_err": 1e-5, "latents_rel_err": 1e-6,
                                              "frames_mae": 0.0}},
         "tdm": {"check_steps": 3, "limits": {"loss_rel_err": 1e-5, "grad_norm_gap": 1e-5,
                                              "change_median_gap": 1e-5}}}


def _tiny_mix(root: Path, name: str) -> str:
    """The full-size training mix with the ASA sizes the tiny preset's
    trainer runs (a 2-block grid: every block selected)."""
    from blade_torch import config as C

    config = json.loads((DATA / f"{name}.json").read_text())
    mix = json.loads((root / "traffic" / f"{TDM_MIX[name]}.json").read_text())
    asa = C.derive_asa_config(C.PRESETS[config["preset"]], "energy")
    mix["asa"].update(sample_gap=asa.sample_gap, min_retain_ratio=asa.min_retain_ratio,
                      max_retain_ratio=asa.max_retain_ratio)
    (root / "traffic" / f"{TDM_MIX[name]}-tiny.json").write_text(json.dumps(mix))
    return f"{TDM_MIX[name]}-tiny"


def make_root(tmp: Path, limits_of=None) -> Path:
    """``tmp/bench_torch`` (the benchmark folder without its tests) and
    ``tmp/BENCHMARK.json``, whose cells are the tiny configurations under
    mix ``t2v`` (cell ``<name>.t2v``) and under their family's training mix
    (``<name>.tdm``), each held to the limits of ``limits_of[cell]`` (by
    default tight limits: the tiny configurations run in f32)."""
    root = tmp / "bench_torch"
    shutil.copytree(REPO / "bench_torch", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = []
    for name in ("wan-tiny", "cogvideox-tiny"):
        shutil.copy(DATA / f"{name}.json", root / "configs" / f"{name}.json")
        for kind, mix in (("t2v", "t2v"), ("tdm", _tiny_mix(root, name))):
            cell = f"{name}.{kind}"
            if limits_of and cell in limits_of:
                shutil.copy(root / "limits" / f"{limits_of[cell]}.json",
                            root / "limits" / f"{cell}.json")
            else:
                (root / "limits" / f"{cell}.json").write_text(json.dumps(TIGHT[kind]))
            bench["workloads"].append({"name": cell, "config": name, "traffic": mix,
                                       "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = m["workloads"][0].rsplit(".", 1)[1]
            m["workloads"] = [w["name"] for w in bench["workloads"]
                              if w["name"].endswith("." + kind)]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def run_tiny():
    """``run_tiny(root, cell, trace=0, seed=...) -> (result, stderr)``: one
    run of a tiny cell on the CPU, the chip's look skipped."""
    import io
    import time

    import torch

    from bench_torch.harness.cell import run_cell
    from bench_torch.harness.registry import Registry

    def run(root, cell, trace=0, seed=2**33 + 5, seconds=0.01):
        reg = Registry(root.parent / "BENCHMARK.json", root)
        out, err = io.StringIO(), io.StringIO()
        rc = run_cell(reg, cell, seed=seed, seconds=seconds, trace=bool(trace),
                      device=torch.device("cpu"), t_start=time.perf_counter(), out=out, err=err)
        assert rc == 0
        return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()

    return run
