"""The port's training pieces against the JAX package, and its trainer's
behaviour, on the CPU.

* flow-matching training math against ``blade.schedulers.unipc_flow`` (f32
  both sides, 1e-6 absolute on values of magnitude <~ 5);
* the six LR schedules against ``blade.training.lr_schedules`` on a grid
  of steps (rtol 1e-5: JAX evaluates in f32, the port in f64);
* LoRA: merge parity through the bridge, including the permuted
  ``attn1.to_q``/``to_k`` (1e-6 absolute), and the adapter count;
* the optimizer against optax (AdamW and Adam behind global-norm clipping,
  with and without MultiSteps accumulation; 1e-6 absolute);
* port-only twins of ``tests/test_tdm.py``: the skip guard, full-model
  training, gradient accumulation, checkpoint resume, and the CLI.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blade.models.wan_dit import WanConfig as JWanConfig
from blade.models.wan_dit import WanModel as JWanModel
from blade.schedulers import unipc_flow as JF
from blade.training import lora as JL
from blade.training.lr_schedules import make_lr_schedule as j_schedule
from blade_torch.cli import train as cli_train
from blade_torch.convert.from_jax import to_torch, wan_lora_factors, wan_transformer_state_dict
from blade_torch.models.wan_dit import WAN_TINY, WanConfig, WanModel
from blade_torch.schedulers import unipc_flow as TF
from blade_torch.training import lora as TL
from blade_torch.training import tdm
from blade_torch.training.checkpointing import CheckpointManager
from blade_torch.training.lr_schedules import SCHEDULE_NAMES, make_lr_schedule
from blade_torch.training.optim import AdamConfig, adam_init, adam_update
from blade_torch.utils.rng import make_generator

CFG = dict(dim=256, ffn_dim=512, num_layers=2, num_heads=2, text_dim=64, freq_dim=32)


def test_flow_training_math_matches_jax():
    table = JF.flow_training_sigmas(1000, 3.0)
    np.testing.assert_array_equal(TF.flow_training_sigmas(1000, 3.0), table)
    rng = np.random.default_rng(0)
    x0, eps, xt = (rng.standard_normal((3, 4, 2, 5)).astype(np.float32) for _ in range(3))
    t1 = np.array([0, 400, 998])
    t2 = np.array([10, 700, 999])
    T = lambda a: torch.from_numpy(np.asarray(a))
    pairs = [
        (TF.flow_add_noise(table, T(x0), T(eps), T(t1)), JF.flow_add_noise(table, x0, eps, t1)),
        (TF.flow_pred_x0(table, T(eps), T(xt), T(t1)), JF.flow_pred_x0(table, eps, xt, t1)),
        (TF.flow_pred_eps(table, T(x0), T(xt), T(t1)), JF.flow_pred_eps(table, x0, xt, t1)),
        (TF.flow_renoise(table, T(xt), T(eps), T(t1), T(t2)),
         JF.flow_renoise(table, xt, eps, t1, t2)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", SCHEDULE_NAMES)
def test_lr_schedules_match_jax(name):
    kw = dict(warmup_steps=10, total_steps=100, num_cycles=2, power=2.0)
    got_fn, want_fn = make_lr_schedule(name, 1e-4, **kw), j_schedule(name, 1e-4, **kw)
    for step in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 101, 150, 1000):
        np.testing.assert_allclose(got_fn(step), float(want_fn(step)), rtol=1e-5, atol=1e-12)


def _jax_params(scan_layers, seed=0):
    model = JWanModel(JWanConfig(**CFG), dtype=jnp.float32, scan_layers=scan_layers)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 2, 8, 8)),
                        jnp.ones((1,)), jnp.zeros((1, 8, 64)))
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


def _jax_lora(params, seed):
    """init_lora with random (non-zero) b factors."""
    lora = JL.init_lora(jax.random.PRNGKey(seed), params, rank=4)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        lora)


def _port_model(params):
    model = WanModel(WanConfig(**CFG), dtype=torch.float32)
    model.load_state_dict(to_torch(wan_transformer_state_dict(params, 2)))
    return model


@pytest.mark.parametrize("scan_layers", [False, True])
def test_lora_merge_matches_jax_through_the_bridge(scan_layers):
    params = _jax_params(scan_layers)
    jlora = _jax_lora(params, 1)
    merged_j = JL.merge_lora(params, jlora, alpha=4.0, rank=4)
    model = _port_model(params)
    base = {n: p.detach() for n, p in model.named_parameters()}
    tlora = to_torch(wan_lora_factors(jlora, 2, 2))
    merged_t = TL.merge_lora(base, tlora, alpha=4.0, rank=4)
    want = dict(_port_model(merged_j).named_parameters())  # stored (permuted) rows
    assert set(merged_t) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(merged_t[name].numpy(), w.detach().numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
    changed = [n for n in base if not torch.equal(base[n], merged_t[n])]
    assert len(changed) == 2 * 8 and all(TL.is_target(n) for n in changed)
    # export: the checkpoint's own order, peft layout
    exp = TL.export_lora(model, tlora, alpha=4.0, rank=4)
    b_q = np.asarray(jlora["params"]["blocks" if scan_layers else "blocks_1"]["attn1"]
                     ["to_q"]["kernel"]["b"])
    np.testing.assert_array_equal(exp["blocks.1.attn1.to_q.lora_B.weight"].T, b_q)


def test_lora_count_matches_jax():
    """One pair per projection per block: JAX's count over the unrolled
    model (its scanned tree shares one pair across layers)."""
    params = _jax_params(False)
    model = _port_model(params)
    base = {n: p.detach() for n, p in model.named_parameters()}
    lora = TL.init_lora(make_generator(0), base, rank=4)
    assert TL.lora_param_count(lora) == JL.lora_param_count(
        JL.init_lora(jax.random.PRNGKey(0), params, rank=4)) == 2 * 8 * 2 * 256 * 4
    merged = TL.merge_lora(base, lora, alpha=4.0, rank=4)  # b = 0: identity
    assert all(torch.equal(merged[n], base[n]) for n in base)


@pytest.mark.parametrize("name,accum", [("adamw", 1), ("adam", 1), ("adamw", 2)])
def test_optimizer_matches_optax(name, accum):
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    sched = lambda n: 0.1 / (1.0 + n)
    if name == "adamw":
        inner = optax.adamw(sched, b1=0.0, b2=0.95, eps=1e-8, weight_decay=1e-2)
    else:
        inner = optax.adam(sched, b1=0.9, b2=0.95, eps=1e-8)
    tx = optax.chain(optax.clip_by_global_norm(1.0), inner)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    cfg = AdamConfig(lr=sched, b1=0.0 if name == "adamw" else 0.9, b2=0.95, eps=1e-8,
                     weight_decay=1e-2 if name == "adamw" else 0.0, max_grad_norm=1.0,
                     grad_accum=accum)
    jp, jst = dict(params), tx.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = adam_init(tp, cfg)
    for i in range(5):
        # alternately below and above the clip norm
        g = {k: (rng.standard_normal(v.shape) * (0.05 if i % 2 else 3.0)).astype(np.float32)
             for k, v in params.items()}
        upd, jst = tx.update(g, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tst = adam_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst, cfg)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)


# ---- port-only behaviour twins of tests/test_tdm.py -------------------------

def _tiny_trainer(**cfg_kw):
    model = WanModel(WAN_TINY, dtype=torch.float32).random_init_(make_generator(1))
    model.requires_grad_(False)
    base = {n: p.detach() for n, p in model.named_parameters()}
    cfg = tdm.TDMConfig(**dict(dict(k_step=2, lambda_reg=0.0, use_weighting_factor=False,
                                    lora_rank=4, lora_alpha=4), **cfg_kw))
    family = tdm.flow_family(TF.flow_training_sigmas(1000, 3.0))
    step = tdm.make_tdm_train_step(cli_train.model_apply_fn(model), family, cfg)
    state = tdm.create_tdm_state(make_generator(4), base, cfg)
    g = torch.Generator().manual_seed(5)
    text = torch.randn(2, 8, WAN_TINY.text_dim, generator=g)
    batch = {"text_embeds": text, "uncond_embeds": text * 0,
             "noise": torch.randn(2, 16, 2, 8, 8, generator=g)}
    return model, state, step, batch


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _moved(a, b):
    return sum(float((a[k] - b[k]).abs().sum()) for k in a)


def test_train_step_updates_adapters_and_freezes_base():
    _, state, step, batch = _tiny_trainer(fake_loss_skip_threshold=1e9)
    new, metrics = step(state, batch, make_generator(6))
    assert np.isfinite(metrics["loss_fake"]) and np.isfinite(metrics["loss_du"])
    assert new.step == 1 and new.base is state.base
    assert _moved(new.lora_g, state.lora_g) > 0 and _moved(new.lora_f, state.lora_f) > 0


def test_skip_guard_rolls_back_fake_adapter_and_its_optimizer_state():
    _, state, step, batch = _tiny_trainer(fake_loss_skip_threshold=1e-6)
    s = state
    for i in range(2):
        s, _ = step(s, batch, make_generator(6 + i))
    assert _same(s.lora_f, state.lora_f) and s.opt_f is state.opt_f
    assert s.opt_f["count"] == 0 and s.opt_g["count"] == 2
    assert _moved(s.lora_g, state.lora_g) > 0


def test_full_model_training_mode():
    _, state, step, batch = _tiny_trainer(train_full_model=True)
    assert set(state.lora_g) == set(state.base)
    new, metrics = step(state, batch, make_generator(7))
    assert np.isfinite(metrics["loss_fake"])
    assert _moved(new.lora_g, state.lora_g) > 0
    assert all(torch.equal(new.base[k], state.base[k]) for k in state.base)


def test_grad_accum_applies_every_n_calls():
    _, state, step, batch = _tiny_trainer(grad_accum=2, fake_loss_skip_threshold=1e9)
    s1, _ = step(state, batch, make_generator(8))
    assert _same(s1.lora_g, state.lora_g) and s1.opt_g["mini_step"] == 1
    s2, _ = step(s1, batch, make_generator(9))
    assert _moved(s2.lora_g, state.lora_g) > 0 and s2.opt_g["count"] == 1
    assert s2.opt_g["mini_step"] == 0


def test_checkpoint_rotation_and_resume_match_an_uninterrupted_run(tmp_path):
    _, state, step, batch = _tiny_trainer(fake_loss_skip_threshold=1e9)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    s = state
    for i in range(3):
        s, _ = step(s, batch, make_generator(10 + i))
        mgr.save(s.step, s)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    uninterrupted, _ = step(s, batch, make_generator(13))
    template = dataclasses.replace(state)  # fresh adapters, same base
    resumed = mgr.restore(template)
    assert resumed.step == 3 and _same(resumed.lora_g, s.lora_g)
    resumed, _ = step(resumed, batch, make_generator(13))
    assert _same(resumed.lora_g, uninterrupted.lora_g)
    assert _same(resumed.lora_f, uninterrupted.lora_f)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(template)


def test_cli_tiny_writes_metrics_and_adapter(tmp_path):
    out = tmp_path / "run"
    args = ["--family", "wan", "--tiny", "--random-init", "--device", "cpu",
            "--max_train_steps", "2", "--batch_size", "1", "--k_step", "2",
            "--checkpointing_steps", "1", "--checkpoints_total_limit", "1",
            "--output_dir", str(out)]
    state, history = cli_train.main(args)
    assert state.step == 2 and len(history) == 2
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss_fake"]) and np.isfinite(r["loss_du"]) for r in recs)
    lora = np.load(out / "tdm_lora.npz")
    assert "blocks.0.attn1.to_q.lora_A.weight" in lora.files
    assert lora["blocks.1.attn2.to_out.0.lora_B.weight"].shape == (WAN_TINY.dim, 64)
    assert CheckpointManager(str(out / "checkpoints")).all_steps() == [2]
    # resume from the latest checkpoint: nothing left to train
    state2, history2 = cli_train.main(args + ["--resume_from_checkpoint", "latest"])
    assert state2.step == 2 and history2 == []
    assert _same(state2.lora_g, state.lora_g)


def test_cli_trains_the_tiny_cogvideox(tmp_path):
    """``python -m blade_torch.cli.train --family cogvideox --tiny``: the DDPM
    family, latents ``[B, T, C, H, W]``, ASA on the energy lane, LoRA on
    ``attn1`` only, the weighting factor on and no fake-loss guard."""
    out = tmp_path / "cog"
    proc = subprocess.run(
        [sys.executable, "-m", "blade_torch.cli.train", "--family", "cogvideox", "--tiny",
         "--random-init", "--device", "cpu", "--max_train_steps", "2", "--batch_size", "1",
         "--k_step", "2", "--output_dir", str(out)],
        capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "latents [1, 3, 16, 16, 16], ASA" in proc.stdout
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss_fake"]) and np.isfinite(r["loss_du"]) for r in recs)
    assert not any(r["fake_skipped"] for r in recs)
    lora = np.load(out / "tdm_lora.npz")
    assert "transformer_blocks.1.attn1.to_out.0.lora_B.weight" in lora.files
    assert not any("attn2" in k for k in lora.files)
    args = cli_train.get_args(["--family", "cogvideox", "--output_dir", "x"])
    cfg = cli_train.tdm_config(args)
    assert cfg.use_weighting_factor and cfg.fake_loss_skip_threshold is None
    preset = cli_train.build_preset(args)
    assert cli_train.latent_shape(preset, 1) == (1, 13, 16, 60, 90)
    assert (preset.text_dim, preset.max_text_len) == (4096, 226)


@pytest.mark.parametrize("flag", [["--prompt_embeds", "x"], ["--report_to", "tensorboard"],
                                  ["--sample_at_checkpoint"], ["--dp", "2"],
                                  ["--optimizer", "prodigy"], ["--use_8bit_adam"]])
def test_cli_refuses_flags_of_later_slices(tmp_path, flag):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli_train.main(["--tiny", "--random-init", "--device", "cpu",
                        "--output_dir", str(tmp_path)] + flag)


def test_import_train_cli_leaves_jax_out():
    code = ("import sys, blade_torch.cli.train, blade_torch.training.tdm, "
            "blade_torch.training.checkpointing; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'blade.'))"
            " or m == 'blade']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
