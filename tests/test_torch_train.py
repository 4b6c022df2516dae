"""The port's training path against the JAX package's on the CPU, in f32,
with the tiny DeepSeek-VL config: the same weights on both sides (JAX
``init_params(key 0)`` -> numpy -> ``from_jax``), the same seeded batches.

Covered: the losses, the loss and autograd gradient of every trainable leaf
against ``jax.value_and_grad`` of ``flmm_tpu``'s ``loss_fn``, AdamW with the
schedule and global-norm clipping against optax, the non-finite guard
against ``optax.apply_if_finite``, two train steps against
``make_train_step``, checkpoints and resume, the trainer entry point, the
derivable synthetic batch and the detaches that keep frozen buffers out of
the gradient.

Tolerances: the losses are the same f32 reductions in another order (1e-6);
the tiny loss and gradients run through 3 decoder and 2 SAM layers in f32
(loss 1e-5 relative, each leaf 1e-3 as max|diff| / max|ref|); the optimizer
states take the same f32 arithmetic in another order (1e-6 relative).
"""

import math
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from flmm_tpu.configs import deepseek_vl as jax_configs
from flmm_tpu.data import synthetic as jsynthetic
from flmm_tpu.models.frozen import base as jbase
from flmm_tpu.models.frozen import deepseek_vl as jmodel
from flmm_tpu.ops import losses as jlosses
from flmm_tpu.train import loop as jloop
from flmm_tpu_torch.configs import deepseek_vl as torch_configs
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data import synthetic
from flmm_tpu_torch.models.frozen import base, deepseek_vl
from flmm_tpu_torch.models.mask_head import refiner
from flmm_tpu_torch.models.sam import mask_decoder, prompt_encoder
from flmm_tpu_torch.ops import losses
from flmm_tpu_torch.train import checkpoint as ckpt
from flmm_tpu_torch.train import loop
from flmm_tpu_torch.train.diagnostics import MetricLogger, nonfinite_guard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-6
GRAD_TOL = 1e-3
OPT_TOL = 1e-6
STEP_TOL = 1e-4


def _jax_loss(jcfg):
    return lambda p, b: jmodel.loss_fn(p, jcfg, b)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params as numpy, two numpy batches)."""
    jcfg, tcfg = jax_configs.tiny(), torch_configs.tiny()
    jparams = jax.device_get(jax.jit(
        lambda k: jmodel.init_params(jcfg, k))(jax.random.key(0)))
    batches = [jsynthetic.synthetic_batch(jcfg, batch_size=2, seed=s)
               for s in range(2)]
    return jcfg, tcfg, jparams, batches


def _port_state(jparams, opt):
    params = from_jax(jparams)
    return params["frozen"], loop.init_state(params["trainable"], opt)


def _loss_targets(rng, B, M, H, W):
    logits = (rng.standard_normal((B, M, H, W)) * 2).astype(np.float32)
    gt = (rng.random((B, M, H, W)) > 0.6).astype(np.float32)
    weight = np.zeros((B, H, W), np.float32)
    for b, (h, w) in enumerate(((H, W), (H // 2, W - 3), (H - 5, W // 3))):
        weight[b, :h, :w] = 1.0  # uneven valid sizes
    return logits, gt * weight[:, None], weight


def test_grounding_losses_match_jax():
    """Uneven mask counts (3, 1, 0 of 4) and uneven valid sizes, so the
    per-sample mask-count weighting differs from a flat mean."""
    rng = np.random.default_rng(0)
    B, M = 3, 4
    mask_valid = np.zeros((B, M), bool)
    mask_valid[0, :3] = mask_valid[1, :1] = True
    coarse = _loss_targets(rng, B, M, 12, 10)
    sam = _loss_targets(rng, B, M, 16, 16)
    args = (*coarse, *sam, mask_valid)
    want = jbase.grounding_losses(*map(jnp.asarray, args))
    got = base.grounding_losses(*map(torch.from_numpy, args))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=key)


@pytest.mark.parametrize("name", ["sigmoid_bce", "naive_dice",
                                  "mask_accuracy", "mask_iou"])
def test_loss_ops_match_jax(name):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((5, 9, 7)) * 3).astype(np.float32)
    gt = (rng.random((5, 9, 7)) > 0.5).astype(np.float32)
    w = (rng.random((5, 9, 7)) > 0.3).astype(np.float32)
    if name == "mask_iou":
        logits = (logits > 0).astype(np.float32)
    for extra in ((), (w,)):
        want = getattr(jlosses, name)(*map(jnp.asarray, (logits, gt, *extra)))
        got = getattr(losses, name)(*map(torch.from_numpy,
                                         (logits, gt, *extra)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    if name == "naive_dice":
        mv = np.array([True, False, True, True, False])
        want = jlosses.naive_dice(*map(jnp.asarray, (logits, gt, w, mv)))
        got = losses.naive_dice(*map(torch.from_numpy, (logits, gt, w, mv)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.fixture(scope="module")
def jax_value_and_grad(tiny):
    jcfg, _, jparams, batches = tiny
    lf = _jax_loss(jcfg)
    vg = jax.jit(jax.value_and_grad(
        lambda tr, fr, b: lf({"frozen": fr, "trainable": tr}, b),
        has_aux=True))
    (loss, metrics), grads = vg(jparams["trainable"], jparams["frozen"],
                                jax.tree.map(jnp.asarray, batches[0]))
    return float(loss), jax.device_get(metrics), jax.device_get(grads)


def test_loss_and_gradients_match_jax(tiny, jax_value_and_grad):
    """Every trainable leaf's autograd gradient against JAX's.  A few leaves
    take an exactly-zero gradient in exact arithmetic -- the key biases of
    the mask decoder's attention (softmax ignores a shift shared by all
    keys) and the first mask-downscaler conv (its LayerNorm over 2 channels
    maps every input to +-1) -- so both sides hold rounding noise there; the
    denominator of the relative error is floored at 1e-5 of the largest
    gradient."""
    jcfg, tcfg, jparams, batches = tiny
    jloss, jmetrics, jgrads = jax_value_and_grad
    frozen, state = _port_state(jparams, loop.make_optimizer(
        loop.OptimConfig()))
    (loss, metrics), grads = loop.value_and_grad(
        lambda p, b: deepseek_vl.loss_fn(p, tcfg, b), frozen,
        state["params"], from_jax(batches[0]))
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(metrics[key].numpy(), want, rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    want = dict(loop.tree_leaves(jgrads))
    assert set(grads) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    for path, ref in want.items():
        got = (np.zeros_like(ref) if grads[path] is None
               else grads[path].numpy())
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-5 * scale)
        assert err <= GRAD_TOL, (path, err)
    assert grads["sam/prompt/pe_gaussian"] is None
    assert grads["text_layer_weights"] is not None
    assert float(grads["text_layer_weights"].abs().max()) > 0
    for path, leaf in loop.tree_leaves(frozen):
        assert not leaf.requires_grad and leaf.grad is None, path


def test_frozen_buffers_are_detached():
    """pe_gaussian feeds the Fourier encoding detached, and the refiner's
    dense-prompt pad value (the ROI minimum, read on the host in the
    reference) carries no gradient into the coarse logits."""
    cfg = torch_configs.tiny().sam
    g = torch.Generator().manual_seed(0)
    params = prompt_encoder.init_params(cfg.prompt, g, "cpu")
    params["pe_gaussian"].requires_grad_(True)
    out = prompt_encoder.dense_pe(params, cfg.prompt).sum() \
        + prompt_encoder.embed_boxes(params, cfg.prompt,
                                     torch.tensor([[3.0, 4.0, 60.0, 90.0]])
                                     ).sum()
    assert out.grad_fn is None  # nothing upstream requires grad
    # the dense prompt: the SAM region covers half the frame, so the
    # bottom-right prompt pixels read only the pad value
    rparams = {"prompt": prompt_encoder.init_params(cfg.prompt, g, "cpu"),
               "decoder": mask_decoder.init_params(cfg.decoder, g, "cpu")}
    coarse = torch.randn((2, 8, 8), generator=g).requires_grad_(True)
    half = cfg.encoder.img_size / 2
    geom = {k: torch.tensor(v) for k, v in dict(
        crop_y=0.0, crop_x=0.0, crop_h=8.0, crop_w=8.0, sam_h=half,
        sam_w=half).items()}
    emb = torch.randn((8, 8, cfg.prompt.embed_dim), generator=g)
    masks = refiner.refine(rparams, cfg, emb, coarse, geom)["prompt_masks"]
    P = cfg.prompt_size
    corner, = torch.autograd.grad(masks[:, -2:, -2:].sum(), coarse,
                                  retain_graph=True)
    assert torch.equal(corner, torch.zeros_like(corner))
    inner, = torch.autograd.grad(masks[:, :P // 4, :P // 4].sum(), coarse)
    assert float(inner.abs().max()) > 0


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _grads_for(params_tree, rng, norm):
    """Random gradients over the trainable tree with global norm ``norm``;
    pe_gaussian's is zero, as JAX's stop_gradient leaves it."""
    leaves = dict(loop.tree_leaves(params_tree))
    grads = {p: rng.standard_normal(np.shape(v)).astype(np.float32)
             for p, v in leaves.items()}
    grads["sam/prompt/pe_gaussian"][:] = 0.0
    total = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                          for g in grads.values()))
    return {p: g * np.float32(norm / total) for p, g in grads.items()}


def _unflatten(flat, like):
    return jax.tree_util.tree_map_with_path(
        lambda path, _: flat[jax.tree_util.keystr(path, simple=True,
                                                  separator="/")], like)


def _assert_params_close(port_params, jax_params):
    want = dict(loop.tree_leaves(jax.device_get(jax_params)))
    for path, p in loop.tree_leaves(port_params):
        np.testing.assert_allclose(p.detach().numpy(), want[path],
                                   rtol=OPT_TOL,
                                   atol=OPT_TOL * np.abs(want[path]).max(),
                                   err_msg=path)


def test_optimizer_matches_optax(tiny):
    """3 updates: the first in the warmup with a norm above 1 (clipped), one
    below 1, one above again."""
    _, _, jparams, _ = tiny
    cfg = loop.OptimConfig(lr=1e-3, total_steps=40)  # warmup: 1 update
    jopt = jloop.make_optimizer(jloop.OptimConfig(lr=1e-3, total_steps=40))
    jstate = jopt.init(_jax_tree(jparams["trainable"]))
    jupdate = jax.jit(jopt.update)
    jp = _jax_tree(jparams["trainable"])
    _, state = _port_state(jparams, loop.make_optimizer(cfg))
    opt = loop.make_optimizer(cfg)
    rng = np.random.default_rng(2)
    pe_before = state["params"]["sam"]["prompt"]["pe_gaussian"].clone()
    for norm in (3.0, 0.5, 7.0):
        flat = _grads_for(jparams["trainable"], rng, norm)
        updates, jstate = jupdate(
            _unflatten(flat, jparams["trainable"]), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        grads = {p: torch.from_numpy(g) for p, g in flat.items()}
        grads["sam/prompt/pe_gaussian"] = None
        state["opt_state"] = opt.update(grads, state["opt_state"],
                                        state["params"])
    _assert_params_close(state["params"], jp)
    assert torch.equal(state["params"]["sam"]["prompt"]["pe_gaussian"],
                       pe_before)
    assert state["opt_state"]["count"] == 3


@pytest.mark.parametrize("count", ["start", "warmup_end", "total"])
def test_schedule_matches_optax(count):
    cfg = loop.OptimConfig(lr=1e-4, total_steps=1000, warmup_ratio=0.03)
    n = {"start": 0, "warmup_end": 30, "total": 1000}[count]
    want = float(jloop.make_schedule(jloop.OptimConfig(
        lr=1e-4, total_steps=1000, warmup_ratio=0.03))(n))
    got = loop.make_schedule(cfg)(n)
    # optax works in f32, where the warmup's start is the difference of two
    # values near lr (ulp 7.3e-12 at 1e-4)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-11)
    assert got == pytest.approx({"start": 1e-9, "warmup_end": 1e-4,
                                 "total": 0.0}[count], abs=1e-15)


def test_nonfinite_guard_matches_optax_apply_if_finite():
    """One good update, 6 bad ones in a row -- the first 5 skipped (no
    parameter, moment or schedule change), the 6th applied -- against
    ``optax.apply_if_finite(make_optimizer, 5)``."""
    small = {"w": np.linspace(-1, 1, 6, dtype=np.float32),
             "pe_gaussian": np.ones((2,), np.float32)}
    cfg = loop.OptimConfig(lr=1e-2, total_steps=20)
    jopt = optax.apply_if_finite(jloop.make_optimizer(jloop.OptimConfig(
        lr=1e-2, total_steps=20)), 5)
    jp = _jax_tree(small)
    jstate = jopt.init(jp)
    opt = nonfinite_guard(loop.make_optimizer(cfg))
    params = {k: torch.from_numpy(v.copy()) for k, v in small.items()}
    state = opt.init(params)
    seq = [np.full(6, 0.3, np.float32)] + [np.full(6, np.nan, np.float32)] * 6
    for i, g in enumerate(seq):
        jgrads = {"w": jnp.asarray(g), "pe_gaussian": jnp.zeros(2)}
        updates, jstate = jopt.update(jgrads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        state = opt.update({"w": torch.from_numpy(g), "pe_gaussian": None},
                           state, params)
        adamw = jstate.inner_state[1].inner_states["train"].inner_state
        count = int(adamw[2].count)  # the schedule's count
        assert int(adamw[0].count) == count  # Adam's bias-correction count
        assert state["inner_state"]["count"] == count, i
        assert state["notfinite_count"] == int(jstate.notfinite_count)
        assert state["total_notfinite"] == int(jstate.total_notfinite)
        assert state["last_finite"] == bool(jstate.last_finite)
        want = np.asarray(jp["w"])
        if i < 6:
            np.testing.assert_allclose(params["w"].numpy(), want, rtol=1e-6)
        else:  # the 6th bad step goes through and poisons w, as in optax
            assert np.isnan(want).all() and params["w"].isnan().all()
    assert [state["inner_state"]["count"], count] == [2, 2]


@pytest.fixture(scope="module")
def jax_two_steps(tiny):
    jcfg, _, jparams, batches = tiny
    ocfg = jloop.OptimConfig(lr=1e-3, total_steps=10)
    opt = jloop.make_optimizer(ocfg)
    step = jax.jit(jloop.make_train_step(_jax_loss(jcfg), opt))
    state = jloop.init_state(_jax_tree(jparams["trainable"]), opt)
    out = []
    for b in batches:
        state, metrics = step(state, _jax_tree(jparams["frozen"]),
                              _jax_tree(b))
        out.append(jax.device_get(metrics))
    return out


def test_train_steps_match_jax(tiny, jax_two_steps):
    """Two ``train_step``s against JAX ``make_train_step``: per-step loss,
    metrics and grad_norm.  (The parameters are not compared: Adam scales
    the rounding noise that the zero-gradient leaves of
    test_loss_and_gradients_match_jax hold up to lr-sized steps, on both
    sides alike.)"""
    _, tcfg, jparams, batches = tiny
    want = jax_two_steps
    opt = loop.make_optimizer(loop.OptimConfig(lr=1e-3, total_steps=10))
    frozen, state = _port_state(jparams, opt)
    step = loop.make_train_step(
        lambda p, b: deepseek_vl.loss_fn(p, tcfg, b), opt)
    for i, b in enumerate(batches):
        state, metrics = step(state, frozen, from_jax(b))
        for key in ("loss", "grad_norm", "loss_mask", "sam_loss_dice"):
            np.testing.assert_allclose(float(metrics[key]), want[i][key],
                                       rtol=STEP_TOL, err_msg=(i, key))
    assert state["step"] == 2 and state["opt_state"]["count"] == 2


def _tiny_run(jparams, tcfg, batches, state=None):
    opt = loop.make_optimizer(loop.OptimConfig(lr=1e-3, total_steps=4))
    frozen, fresh = _port_state(jparams, opt)
    state = fresh if state is None else state
    step = loop.make_train_step(
        lambda p, b: deepseek_vl.loss_fn(p, tcfg, b), opt)
    for b in batches:
        state, _ = step(state, frozen, from_jax(b))
    return state


def test_checkpoint_round_trip_and_resume(tiny, tmp_path):
    """save / restore / latest, and 2 steps + save + restore into a fresh
    state + 2 steps equal 4 uninterrupted steps, bit for bit."""
    jcfg, tcfg, jparams, batches = tiny
    batches = batches + [jsynthetic.synthetic_batch(jcfg, batch_size=2,
                                                    seed=s) for s in (2, 3)]
    full = _tiny_run(jparams, tcfg, batches)
    half = _tiny_run(jparams, tcfg, batches[:2])
    ckpt.save(tmp_path / "step_2", half)
    ckpt.save(tmp_path / "step_10", half)
    ckpt.save(tmp_path / "step_2", half)  # overwriting is allowed
    assert ckpt.latest(tmp_path).name == "step_10"
    assert ckpt.latest(tmp_path / "missing") is None
    _, fresh = _port_state(jparams, loop.make_optimizer(loop.OptimConfig()))
    restored = ckpt.restore(tmp_path / "step_2", fresh)
    assert restored["step"] == 2 and restored["opt_state"]["count"] == 2
    for (path, a), (_, b) in zip(loop.tree_leaves(half),
                                 loop.tree_leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
            assert a.requires_grad == b.requires_grad, path
    resumed = _tiny_run(jparams, tcfg, batches[2:], state=restored)
    for (path, a), (_, b) in zip(loop.tree_leaves(full),
                                 loop.tree_leaves(resumed)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
        else:
            assert a == b, path


def _trainer(args, tmp_path, cuda_visible=""):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = cuda_visible
    return subprocess.run(
        [sys.executable, "-m", "flmm_tpu_torch.train", "--preset", "tiny",
         "--synthetic", "--steps", "3", "--work-dir", str(tmp_path / "wd"),
         "--log-interval", "1", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("task", ["random", "grounding"])
def test_trainer_runs_on_cpu(tmp_path, task):
    proc = _trainer(["--device", "cpu", "--synthetic-task", task,
                     "--nonfinite-guard"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 3 and "saved step_3" in proc.stdout
    assert (tmp_path / "wd" / "step_3" / ckpt.STATE_FILE).exists()
    assert len((tmp_path / "wd" / "metrics.jsonl").read_text().splitlines()) \
        == 3
    if task == "random":
        proc = _trainer(["--device", "cpu", "--nonfinite-guard", "--resume"],
                        tmp_path)
        assert proc.returncode == 0, proc.stderr
        assert "at step 3" in proc.stdout


def test_trainer_needs_a_card_by_default(tmp_path):
    proc = _trainer([], tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_metric_logger_writes_every_interval(tmp_path):
    log = MetricLogger(path=str(tmp_path / "m.jsonl"), interval=2)
    for step in range(1, 6):
        log.log(step, {"loss": torch.tensor(step * 0.5)})
    log.close()
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert lines == ['{"step": 2, "loss": 1.0}', '{"step": 4, "loss": 2.0}']


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_grounding_batch_matches_jax(tiny, seed):
    jcfg, tcfg, _, _ = tiny
    want = jsynthetic.synthetic_grounding_batch(jcfg, batch_size=3,
                                                seed=seed)
    got = synthetic.synthetic_grounding_batch(tcfg, batch_size=3, seed=seed)
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "geom":
            assert set(got[key]) == set(w)
            for k in w:
                np.testing.assert_array_equal(got[key][k], w[k])
        else:
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
