"""The port's twins of the JAX package's three measurement scripts on the
CPU (``--device cpu``, tiny sizes):

* ``train_overlap_bench``: the JSON line's keys are the JAX script's (read
  off scripts/train_overlap_bench.py as text), in its order, with
  ``data_wait_s`` after ``overlap_factor``; the times are positive and
  the loader's blocked time lies inside a step.
* ``sam_size_accuracy_proxy``: ``run`` at the tiny twin at half SAM size
  for 2 steps against the JAX script's ``run`` on one set of weights (the
  port's seeded init, carried to JAX as arrays and to the port by
  ``convert.from_jax``): ``aiou``, ``sam_aiou`` and ``loss`` within 1e-3;
  ``main``'s lines and keys.
* ``fused_piece_bench``: the six cases in the JAX script's order (its
  ``*_xla`` cases named ``*_plain``), each fused op against its plain piece,
  and the plain pieces against the JAX script's XLA compositions
  (``layer_norm``, ``mlp_block``) in f32 at 1e-5.
"""

import json
import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu_torch import fused_piece_bench, sam_size_accuracy_proxy, \
    train_overlap_bench
from flmm_tpu_torch.convert.from_jax import from_jax

REPO = pathlib.Path(__file__).resolve().parent.parent
PROXY_TOL, PIECE_TOL = 1e-3, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the toy steps run many small ops, which a
    contended CPU runs far slower on all its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_train_overlap_bench_keys(capsys):
    src = (REPO / "scripts" / "train_overlap_bench.py").read_text()
    block = src[src.index("print(json.dumps"):]
    jax_keys = re.findall(r'"(\w+)":', block[:block.index("}))")])
    out = train_overlap_bench.main([
        "--device", "cpu", "--preset", "tiny", "--batch-size", "2",
        "--steps", "2", "--workers", "2"])
    line, = _json_lines(capsys.readouterr().out)
    keys = list(jax_keys)
    keys.insert(keys.index("overlap_factor") + 1, "data_wait_s")
    assert list(line) == keys == list(out)
    assert line["preset"] == "tiny" and line["batch_size"] == 2
    for k in ("device_step_s", "host_batch_gen_s", "overlapped_step_s",
              "overlap_factor", "steps_per_s_overlapped"):
        assert line[k] > 0, k
    assert 0 <= line["data_wait_s"] <= line["overlapped_step_s"]


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree.detach().numpy()


def test_sam_size_proxy_run_matches_jax(monkeypatch):
    """Two bs-8 steps of the tiny twin at SAM 64 on the same weights."""
    from flmm_tpu.configs.deepseek_vl import tiny as jtiny
    from flmm_tpu.models.frozen import grounding as jmodel
    from flmm_tpu.registry import with_sam_size as jwith_sam_size
    from flmm_tpu_torch.configs.deepseek_vl import tiny
    from flmm_tpu_torch.models.frozen import grounding as model
    from flmm_tpu_torch.registry import with_sam_size
    from scripts import sam_size_accuracy_proxy as jproxy

    cfg = with_sam_size(tiny(), 64)
    weights = _numpy(model.init_params(cfg, torch.Generator().manual_seed(3),
                                       "cpu"))
    monkeypatch.setattr(jmodel, "init_params", lambda cfg, key: jax.tree.map(
        jnp.asarray, weights))
    monkeypatch.setattr(model, "init_params",
                        lambda cfg, g, device: from_jax(weights, device))
    want = jproxy.run(jwith_sam_size(jtiny(), 64), 2, 5e-3, 1, seed=0)
    got = sam_size_accuracy_proxy.run(cfg, 2, 5e-3, 1, seed=0, device="cpu")
    assert list(got) == list(want) + ["head_loss", "head_aiou"]
    for k, v in want.items():
        assert abs(got[k] - v) <= PROXY_TOL, (k, got[k], v)


def test_sam_size_proxy_main_lines(capsys):
    out = sam_size_accuracy_proxy.main([
        "--device", "cpu", "--steps", "2", "--tail", "1", "--sizes", "0.5",
        "--seeds", "1", "--seed", "2"])
    lines = _json_lines(capsys.readouterr().out)
    assert [list(x)[:3] for x in lines[:1]] == [["frac", "sam_size", "seed"]]
    assert lines[0]["seed"] == 2 and lines[0]["sam_size"] == 64
    assert set(lines[0]) == {"frac", "sam_size", "seed", "aiou", "sam_aiou",
                             "loss", "head_loss", "head_aiou"}
    assert list(lines[1]) == ["0.5"]
    assert lines[2] == out and list(out) == ["proxy", "steps", "seeds",
                                             "curve"]
    assert out["curve"]["0.5"]["mean"]["loss"] == lines[0]["loss"]


def test_fused_piece_bench_cases(capsys):
    src = (REPO / "scripts" / "fused_piece_bench.py").read_text()
    names = [n.replace("_xla", "_plain")
             for n in re.findall(r'^\s+"(\w+)": lambda', src, re.M)]
    fused_piece_bench.main(["--device", "cpu", "--tokens", "64"])
    rows = _json_lines(capsys.readouterr().out)
    assert [r["op"] for r in rows] == names and len(names) == 6
    for r in rows:
        assert r["ms"] > 0 and r["launches"] == 0  # CPU: the plain twins
        if r["op"].endswith("_fused"):
            assert r["vs_plain"] == 0.0


def test_fused_pieces_match_the_jax_compositions():
    """Each fused op and its plain piece in f32 at N = 64 against the JAX
    script's XLA expression of the same piece."""
    from flmm_tpu.models.sam.common import layer_norm, mlp_block

    x, attn, p = fused_piece_bench.make_inputs(64, 128, 256, "cpu", seed=1,
                                               dtype=torch.float32)
    jx, ja = jnp.asarray(x.numpy()), jnp.asarray(attn.numpy())
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    mlp = {k: jp[k] for k in ("w1", "b1", "w2", "b2")}
    want = {
        "ln_qkv": layer_norm(jx, jp["ln_w"], jp["ln_b"], 1e-6) @ jp["wqkv"]
        + jp["bqkv"],
        "proj_ln_mlp": (lambda xr: xr + mlp_block(
            layer_norm(xr, jp["ln_w"], jp["ln_b"], 1e-6), mlp))(
            jx + ja @ jp["wo"] + jp["bo"]),
        "ln_mlp": jx + mlp_block(layer_norm(jx, jp["ln_w"], jp["ln_b"],
                                            1e-6), mlp),
    }
    with torch.no_grad():
        for name, (fn, _) in fused_piece_bench.cases(attn).items():
            piece = name.rsplit("_", 1)[0]
            np.testing.assert_allclose(fn(x, p).numpy(),
                                       np.asarray(want[piece]),
                                       atol=PIECE_TOL, rtol=PIECE_TOL,
                                       err_msg=name)
