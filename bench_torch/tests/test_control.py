"""What the comparison that decides ``correct`` catches, on the CPU at the
tiny sizes, held to the full-size cells' limits: the control (the
reference a precision lower in the program's place) and the faults a
text-to-video or a training cell can have, each planted in the program
underneath a whole run (a training cell at batch 1 on one chip has no half
batch to leave out and no exchange between chips)."""

import pytest
import torch

from conftest import LIMITS_OF, make_root

FAMILIES = ["wan-tiny", "cogvideox-tiny"]


@pytest.fixture
def cells(tmp_path):
    return make_root(tmp_path, limits_of=LIMITS_OF)


@pytest.mark.parametrize("name", FAMILIES)
def test_control_fails_the_limits(cells, name):
    from bench_torch.harness.registry import Registry
    from bench_torch.harness.trace import Spans

    reg = Registry(cells.parent / "BENCHMARK.json", cells)
    limits = reg.limits(f"{name}.t2v")["limits"]
    for seed in (3, 2**35 + 9):
        driver = reg.module("drivers", "t2v").Driver(
            reg.config(name), reg.traffic("t2v"), seed=seed, device=torch.device("cpu"),
            spans=Spans(False))
        driver.issue(0)
        got = driver.check(reg.limits(f"{name}.t2v")["check_steps"], control=True)
        assert all(got[k] <= lim for k, lim in limits.items()), got
        failed = [k for k, lim in limits.items() if got[f"control.{k}"] > lim]
        assert failed, got


def _dit_class(name):
    if name == "wan-tiny":
        from blade_torch.models.wan_dit import WanModel
        return WanModel
    from blade_torch.models.cogvideox_dit import CogVideoXModel
    return CogVideoXModel


def _plant_velocity(monkeypatch, name):
    """An answer altered where it is produced: every velocity 5 % off."""
    cls = _dit_class(name)
    forward = cls.forward
    monkeypatch.setattr(cls, "forward", lambda self, *a, **kw: forward(self, *a, **kw) * 1.05)


def _plant_frames(monkeypatch, name):
    """Frames altered where they are produced: one uint8 level up."""
    from blade_torch.sampling.t2v import T2VPipeline

    to_u8 = T2VPipeline.frames_to_uint8
    monkeypatch.setattr(T2VPipeline, "frames_to_uint8",
                        staticmethod(lambda f: (to_u8(f).int() + 1).clamp(max=255).to(torch.uint8)))


def _plant_step(monkeypatch, name):
    """A sampler step altered where it is produced: its state 0.1 % off."""
    import blade_torch.sampling.pipeline as P
    from blade_torch.schedulers import unipc_flow

    if name == "wan-tiny":
        step = unipc_flow.unipc_step
        monkeypatch.setattr(unipc_flow, "unipc_step",
                            lambda *a, **kw: step(*a, **kw)._replace(x=step(*a, **kw).x * 1.001))
    else:
        step = P.dpm_step
        monkeypatch.setattr(P, "dpm_step",
                            lambda *a, **kw: step(*a, **kw)._replace(x=step(*a, **kw).x * 1.001))


@pytest.mark.parametrize("plant, caught", [
    (_plant_velocity, "velocity_rel_err"),
    (_plant_frames, "frames_mae"),
    (_plant_step, "latents_rel_err"),
])
@pytest.mark.parametrize("name", FAMILIES)
def test_a_planted_fault_makes_the_run_not_correct(cells, run_tiny, monkeypatch, name, plant,
                                                   caught):
    plant(monkeypatch, name)
    result, err = run_tiny(cells, f"{name}.t2v")
    assert result["correct"] is False
    check = result["checks"][caught]
    assert check["value"] > check["limit"]
    assert err.strip().splitlines()[-1] == "correct False"


def _tdm_driver(cells, name, seed):
    from bench_torch.harness.registry import Registry
    from bench_torch.harness.trace import Spans

    reg = Registry(cells.parent / "BENCHMARK.json", cells)
    cell = f"{name}.tdm"
    limits = reg.limits(cell)
    driver = reg.module("drivers", "tdm").Driver(
        reg.config(name), reg.traffic(reg.workload(cell)["traffic"]), seed=seed,
        device=torch.device("cpu"), spans=Spans(False), check_steps=limits["check_steps"])
    return driver, limits


# The tiny configurations whose full-size training cell is in the benchmark.
TDM_CELLS = ["cogvideox-tiny"]


@pytest.mark.parametrize("name", TDM_CELLS)
def test_tdm_control_fails_the_limits(cells, name):
    for seed in (3, 2**35 + 9):
        driver, limits = _tdm_driver(cells, name, seed)
        driver.control_unit()
        got = driver.check(limits["check_steps"], control=True)
        assert all(got[k] <= lim for k, lim in limits["limits"].items()), got
        assert [k for k, lim in limits["limits"].items() if got[f"control.{k}"] > lim], got


def _plant_unchanged(monkeypatch, name):
    """A step that returns its state unchanged (its step count moved on)."""
    import dataclasses

    from blade_torch.training import tdm

    make = tdm.make_tdm_train_step

    def planted(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch, generator=None, **k):
            return dataclasses.replace(state, step=state.step + 1), step(state, batch,
                                                                         generator, **k)[1]
        return run

    monkeypatch.setattr(tdm, "make_tdm_train_step", planted)


@pytest.mark.parametrize("plant, caught", [
    (_plant_unchanged, "change_median_gap"),
    (_plant_velocity, "grad_norm_gap"),
])
@pytest.mark.parametrize("name", TDM_CELLS)
def test_a_planted_training_fault_makes_the_run_not_correct(cells, run_tiny, monkeypatch, name,
                                                            plant, caught):
    plant(monkeypatch, name)
    result, err = run_tiny(cells, f"{name}.tdm")
    assert result["correct"] is False
    check = result["checks"][caught]
    assert check["value"] > check["limit"]
    assert err.strip().splitlines()[-1] == "correct False"
