"""The parallel slice of the port (flmm_tpu_torch/parallel, evalsuite/
sharded.py, the data-parallel train step) against the JAX package on the
CPU.

One gloo group of 4 ranks serves the whole module (tests/
torch_parallel_workers.py: the ranks import torch and the port only); the
2 x 2, 4 x 1 and 1 x 2 meshes are cut from it.  The JAX references run on
conftest's 8 virtual devices (see the module fixture).  The JAX modules
for these paths (tests/test_eval.py, test_train.py, test_pipeline.py) are
marked slow, so this module is their tier-1 pin:

(i) the spec trees of ``param_shardings`` for every JAX preset, tp and
    fsdp at a model axis of 2, from ``jax.eval_shape`` (no weights);
(ii) ``run_eval_sharded`` at tiny on 5 samples (the pad path) against the
    JAX ``run_eval_sharded`` on a 4-device mesh and the port's host path,
    within 1e-4 (tests/test_eval.py:229,242); ``make_sharded_eval_step``'s
    summed terms against the one-rank terms and JAX's ``batch_iou_terms``;
(iii) the dp + tp step at 2 x 2 against the JAX ``jit_train_step`` on a
    batch whose data shards hold different mask counts: loss rtol 2e-4
    (tests/test_train.py), the updated trainable tree 1e-3;
(iv) the tp forward at tiny and at the MoE tiny (experts split over
    ``"model"``), with the split ``lm_head``: 1e-3 of the JAX forward and
    of the port's one-rank forward;
(v) fsdp on the 4-layer twin (tiny's 3 layers fall back to replicated):
    1e-3 of the JAX forward, and the port's one-rank forward bit for bit;
(vi) the GPipe capture against the JAX ``pipeline_forward_capture`` at
    tests/test_pipeline.py's setups, dense and MoE: atol 2e-5;
(vii) the refiner's multimask selection against the JAX refiner: 1e-4;
(viii) the sequence-sharded decoder (``forward_capture(seq_axis=...)``,
    the 2 x 2 mesh's ``"model"`` axis splitting the rows) at
    ``dryrun_multichip``'s 4-layer twin, batch seed 4, S = 99 (50 + 49
    rows), and at an aligned S = 256 with the image block at 128 and the
    flash gate open (K5's plain twin on rows 128-255 at ``q_offset`` 128),
    in the mean, max and raw forms: 1e-3 of the JAX ``forward_capture``
    under ``with_sharding_constraint(h, P('data', 'model', None))`` and
    1e-5 of the port's one-rank forward; the refusals (a tp tree, a KV
    cache, K5 on chunks that are not 128-row multiples).

The weights come from the port's seeded init (the JAX init compiles for
~35 s here).  The module fixture hands every rank task to the pool and
every JAX reference to two spawned processes at once (tracing holds the
interpreter lock, so threads would run them in turn), so the references
overlap each other and the ranks' work; each test reads its pair of
results.
"""

import concurrent.futures
import dataclasses
import multiprocessing
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from flmm_tpu import registry as jregistry
from flmm_tpu.configs.deepseek_vl import tiny as jtiny
from flmm_tpu.models.frozen import grounding as jmodel
from flmm_tpu.parallel import mesh as jmesh
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.models.frozen import grounding as tmodel
from flmm_tpu_torch.models.llm import decoder as tdecoder
from tests import torch_parallel_workers as workers

EVAL_TOL = 1e-4
LOSS_RTOL = 2e-4
TREE_TOL = 1e-3
FORWARD_TOL = 1e-3
PIPELINE_ATOL = 2e-5
REFINER_TOL = 1e-4
SEQ_ONE_RANK_TOL = 1e-5
SEQ_FORMS = ["mean", "max", "raw"]
SEQ_CASES = ["dryrun", "aligned"]
KEYS = ("coarse_logits", "sam_logits", "iou_pred", "hidden")
FORWARD_CASES = [("dense", "tp"), ("moe", "tp"), ("layers4", "fsdp")]
PIPELINE_FIELDS = dict(vocab_size=64, hidden_size=32, num_layers=4,
                       num_heads=4, num_kv_heads=2, head_dim=8,
                       intermediate_size=64)


def _jax_cfg(variant: str):
    base = jtiny()
    if variant == "moe":
        return dataclasses.replace(base, llm=dataclasses.replace(
            base.llm, num_experts=4, num_experts_per_tok=2))
    if variant == "layers4":
        return dataclasses.replace(
            base, llm=dataclasses.replace(base.llm, num_layers=4),
            unet=dataclasses.replace(base.unet,
                                     in_channels=4 * base.llm.num_heads))
    return base


def _params(variant: str, seed: int) -> dict:
    """The port's seeded init of a tiny variant, as numpy."""
    g = torch.Generator().manual_seed(seed)
    return workers._numpy(tmodel.init_params(workers._tiny(variant), g,
                                             "cpu"))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _shape_tree(tree):
    """A JAX abstract tree as nested dicts / lists of Shape leaves."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_tree(v) for v in tree]
    return workers.Shape(tree.shape)


def _key(p):
    return getattr(p, "key", getattr(p, "idx", None))


def _spec_trees():
    """The shape tree of every JAX preset and its JAX specs (tp, fsdp) at
    a 2 x 2 mesh: ``(path keys, spec tuple)`` pairs."""
    trees, want = {}, {}
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    for family, fam in jregistry.FAMILIES.items():
        model = jregistry.get_model(family)
        for preset in fam.presets:
            cfg = jregistry.get_config(family, preset)
            abstract = jax.eval_shape(lambda k: model.init_params(cfg, k),
                                      jax.random.key(0))
            name = f"{family}/{preset}"
            trees[name] = _shape_tree(abstract)
            want[name] = {mode: [
                (tuple(_key(p) for p in path), tuple(sh.spec))
                for path, sh in jax.tree_util.tree_flatten_with_path(
                    jmesh.param_shardings(mesh, abstract, mode))[0]]
                for mode in ("tp", "fsdp")}
    return trees, want


def _eval_case():
    from flmm_tpu.data.collate import BatchSpec
    from flmm_tpu.data.processors import ProcessorConfig
    from flmm_tpu.models.mask_head.unet import output_hw

    cfg = jtiny()
    spec = lambda samples: BatchSpec(  # noqa: E731
        seq_len=max(len(s["input_ids"]) for s in samples) + 16,
        max_masks=2, text_per_mask=8,
        coarse_hw=output_hw(cfg.unet, (cfg.clip_shape, cfg.clip_shape)),
        sam_size=cfg.sam.encoder.img_size, prompt_size=cfg.sam.prompt_size,
        processor=ProcessorConfig(size=cfg.input_size))
    return cfg, spec


def _jax_sharded_eval(params):
    """The JAX ``run_eval_sharded`` over a 4-device mesh: its own body,
    the jitted forward shared by the RefCOCO and PNG scorers (one
    compile)."""
    from flmm_tpu.data.synthetic import synthetic_samples
    from flmm_tpu.evalsuite.metrics import PNGAccumulator, RefSegAccumulator
    from flmm_tpu.evalsuite.runner import png_score, refcoco_score, run_eval
    from flmm_tpu.evalsuite.sharded import make_sharded_predict

    cfg, spec = _eval_case()
    samples = synthetic_samples(cfg, 5, seed=0)  # 5 % 4 != 0: pad path
    mesh = jmesh.make_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    predict = make_sharded_predict(lambda p, b: jmodel.forward(p, cfg, b),
                                   _jnp(params), mesh)
    return {"refcoco": run_eval(iter(samples), predict, spec(samples), 4,
                                RefSegAccumulator, refcoco_score).results(),
            "png": run_eval(iter(samples), predict, spec(samples), 4,
                            PNGAccumulator, png_score).results()}


def _train_batch():
    from flmm_tpu.data.synthetic import synthetic_batch

    batch = synthetic_batch(jtiny(), batch_size=4, max_masks=3)
    batch["mask_valid"][2:, 1:] = False  # data shard 1 holds 2 masks
    return batch


def _jax_train_step(params, batch):
    from flmm_tpu.train import loop as jloop

    cfg = jtiny()
    params = _jnp(params)
    opt = jloop.make_optimizer(jloop.OptimConfig(lr=1e-3, total_steps=50,
                                                 warmup_ratio=0.0))
    state = jloop.init_state(params["trainable"], opt)
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    jbatch = _jnp(batch)
    with mesh:
        step = jloop.jit_train_step(
            lambda p, b: jmodel.loss_fn(p, cfg, b), opt, mesh, state,
            params["frozen"], jbatch)
        frozen = jax.device_put(params["frozen"], jmesh.param_shardings(
            mesh, params["frozen"]))
        state, metrics = step(
            jax.device_put(state, jmesh.replicated(mesh, state)), frozen,
            jax.device_put(jbatch, jmesh.batch_shardings(mesh, jbatch)))
    return jax.device_get(metrics), jax.device_get(state["params"])


def _forward_batch(variant: str):
    from flmm_tpu.data.synthetic import synthetic_batch

    return synthetic_batch(_jax_cfg(variant), batch_size=2, seed=1)


def _jax_forward(variant, params, batch):
    cfg = _jax_cfg(variant)
    return jax.device_get(jax.jit(lambda p, b: jmodel.forward(p, cfg, b))(
        _jnp(params), _jnp(batch)))


def _pipeline_case(moe: bool):
    """tests/test_pipeline.py's setups: the dense one with a merge matrix,
    the MoE one with the raw capture (weights: the port's init)."""
    fields = dict(PIPELINE_FIELDS)
    if moe:
        fields.update(num_experts=4, num_experts_per_tok=2)
    g = torch.Generator().manual_seed(3 if moe else 0)
    params = workers._numpy(tdecoder.init_params(
        tdecoder.DecoderConfig(**fields, dtype=torch.float32), g, "cpu"))
    rng = np.random.default_rng(5 if moe else 0)
    B, S = 4, (10 if moe else 12)
    x = {"embeds": params["embed"][rng.integers(0, 64, (B, S))]}
    if moe:
        x.update(mask=np.ones((B, S), bool), img_start=np.int32(1),
                 n_img=np.int32(4))
    else:
        x.update(mask=rng.random((B, S)) > 0.1,
                 mm=(rng.random((B, S, 3)) * (rng.random((B, S, 3)) > 0.5)
                     ).astype(np.float32),
                 img_start=np.int32(2), n_img=np.int32(5))
    w = rng.normal(size=(4,)).astype(np.float32)
    x["w"] = np.exp(w) / np.exp(w).sum()
    return fields, params, x


def _jax_pipeline(fields, params, x):
    from flmm_tpu.models.llm.decoder import DecoderConfig
    from flmm_tpu.parallel.pipeline import pipeline_forward_capture

    cfg = DecoderConfig(**fields, dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    return jax.device_get(jax.jit(
        lambda p, e, m, t, w: pipeline_forward_capture(
            p, cfg, e, m, int(x["img_start"]), int(x["n_img"]), mesh=mesh,
            n_microbatches=2, merge_matrix=t, layer_weights=w))(
        _jnp(params), x["embeds"], x["mask"], x.get("mm"), x["w"]))


def _sequence_case(case: str) -> dict:
    """The 4-layer twin's decoder (the port's seeded init) and its inputs:
    ``dryrun`` the dryrun's batch (seed 4, S = 99, image block at 3),
    ``aligned`` S = 256 with the image block at 128, key holes and masks
    on both ranks' rows (one across the split at 128)."""
    from flmm_tpu.data.synthetic import synthetic_batch
    from flmm_tpu.ops.masks import mean_merge_matrix

    cfg = _jax_cfg("layers4")
    params = _params("layers4", 5)["frozen"]["llm"]
    fields = {f.name: getattr(cfg.llm, f.name)
              for f in dataclasses.fields(cfg.llm) if f.name != "dtype"}
    if case == "dryrun":
        batch = synthetic_batch(cfg, batch_size=2, seed=4)
        ids, mask = batch["input_ids"], batch["attn_mask"]
        mask_ids, img_start = batch["mask_ids"], cfg.img_start
        fields["use_flash_capture"] = False
    else:
        rng = np.random.default_rng(6)
        S, img_start = 256, 128
        ids = rng.integers(0, cfg.llm.vocab_size, (2, S))
        mask = np.ones((2, S), bool)
        mask[0, 200:206] = mask[1, 240:] = mask[1, 150:152] = False
        mask_ids = np.full((2, S), -1, np.int32)
        mask_ids[:, 10:15] = 0  # before the image: captures nothing
        mask_ids[:, 120:136] = 1  # across the split
        mask_ids[0, 196:230] = mask_ids[1, 200:212] = 2
        fields["use_flash_capture"] = True
    mm = np.stack([np.asarray(mean_merge_matrix(jnp.asarray(row), 3))
                   for row in mask_ids]).astype(np.float32)
    w = np.random.default_rng(7).normal(size=(4,)).astype(np.float32)
    inputs = {"embeds": params["embed"][ids], "mask": mask,
              "mm_mean": mm, "mm_max": mm}
    return dict(params=params, inputs=inputs, fields=fields,
                img_start=int(img_start), n_img=cfg.num_img_tokens,
                layer_weights=np.exp(w) / np.exp(w).sum(), forms=SEQ_FORMS)


def _jax_sequence(params, inputs, fields, img_start, n_img, layer_weights,
                  forms):
    """The JAX ``forward_capture`` under ``dryrun_multichip``'s sequence
    constraint on a 2 x 2 mesh, the XLA capture (gate closed)."""
    from jax.sharding import PartitionSpec as P

    from flmm_tpu.models.llm import decoder as jdecoder

    cfg = jdecoder.DecoderConfig(**{**fields, "use_flash_capture": False},
                                 dtype=jnp.float32)
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])

    def fwd(p, x, w):
        return {form: jdecoder.forward_capture(
            p, cfg, x["embeds"], x["mask"], img_start=img_start, n_img=n_img,
            merge_matrix=None if form == "raw" else x[f"mm_{form}"],
            merge="mean" if form == "raw" else form, layer_weights=w,
            shard_constraint=lambda h: jax.lax.with_sharding_constraint(
                h, P("data", "model", None))) for form in forms}

    with mesh:
        return jax.device_get(jax.jit(fwd)(_jnp(params), _jnp(inputs),
                                           jnp.asarray(layer_weights)))


def _reference_process():
    """A JAX reference process compiles without LLVM's optimisations:
    about a third less CPU for the same HLO, which fixes the numbers."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0")


@pytest.fixture(scope="module")
def jobs():
    """``{name: (rank results, JAX reference)}`` callables: every rank
    task and every reference started at once."""
    pool = workers.Pool(4)
    refs = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"),
        initializer=_reference_process)
    out = {}
    try:
        # the longest references first
        params, batch = _params("dense", 0), _train_batch()
        out["train"] = (pool.submit("dp_tp_step", params=params,
                                    batch=batch),
                        refs.submit(_jax_train_step, params, batch))
        out["specs"] = (None, refs.submit(_spec_trees))
        out["eval"] = (pool.submit("sharded_eval", params=params,
                                   n_samples=5),
                       refs.submit(_jax_sharded_eval, params))
        for variant, mode in FORWARD_CASES:
            fp, fb = _params(variant, 1), _forward_batch(variant)
            out[variant] = (pool.submit("model_parallel_forward", params=fp,
                                        batch=fb, variant=variant,
                                        mode=mode),
                            refs.submit(_jax_forward, variant, fp, fb))
        for moe in (False, True):
            fields, pp, x = _pipeline_case(moe)
            n_mbs = (2,) if moe else (2, 4)
            out[f"pipeline_{moe}"] = (
                [(n, pool.submit("pipeline", params=pp, inputs=x,
                                 cfg_fields=fields, n_microbatches=n))
                 for n in n_mbs],
                refs.submit(_jax_pipeline, fields, pp, x))
        for case in SEQ_CASES:
            args = _sequence_case(case)
            out[f"seq_{case}"] = (pool.submit("sequence_forward", **args),
                                  refs.submit(_jax_sequence, **args))
        case = _refiner_case()
        out["refiner"] = (case, refs.submit(_jax_refine, *case))

        done = {}  # a name's results, for the tests that read it again

        def read(name):
            if name in done:
                return done[name]
            ticket, ref = out[name]
            want = ref and ref.result()
            if name == "specs":  # the ranks take the traced shape trees
                got = pool.run("specs", trees=want[0])
            elif isinstance(ticket, list):
                got = [(n, pool.collect(t)) for n, t in ticket]
            else:
                got = pool.collect(ticket) if isinstance(ticket, int) \
                    else ticket
            done[name] = got, want
            return got, want
        yield read
    finally:
        refs.shutdown(wait=True, cancel_futures=True)
        pool.close()


def test_spec_trees_match_every_preset(jobs):
    got, (_, want) = jobs("specs")
    batch = {"input_ids": np.zeros((4, 9)), "geom": {"sam_h": np.zeros(4)}}
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    for kind, fn in (("batch", jmesh.batch_shardings),
                     ("replicated", jmesh.replicated)):
        assert got[0][kind] == jax.tree.map(lambda sh: tuple(sh.spec),
                                            fn(mesh, batch)), kind
    got = got[0]["params"]
    split = 0
    for name, modes in want.items():
        for mode, leaves in modes.items():
            for path, spec in leaves:
                node = got[name][mode]
                for p in path:
                    node = node[p]
                assert node == spec, (name, mode, path)
                split += "model" in node
    assert split > 0


def test_sharded_eval_matches_jax_and_the_host_path(jobs):
    from flmm_tpu.data.synthetic import synthetic_batch
    from flmm_tpu.evalsuite.sharded import batch_iou_terms, finalize

    got, want = jobs("eval")
    assert any("thing" in k for k in want["png"])
    # make_sharded_eval_step: the terms summed over the 4 data ranks equal
    # the one-rank terms, which equal the JAX batch_iou_terms of the logits
    b = synthetic_batch(jtiny(), batch_size=4, seed=2)
    jstep = finalize(batch_iou_terms(got[0]["step_logits"], b["gt_sam"],
                                     b["sam_weight"], b["mask_valid"]))
    assert jstep["n"] == got[0]["step_host"]["n"] > 0
    for rank in got:
        for k, v in jstep.items():
            assert abs(rank["step"][k] - got[0]["step_host"][k]) < EVAL_TOL
            assert abs(got[0]["step_host"][k] - v) < EVAL_TOL, k
    for rank in got:
        for kind in ("refcoco", "png"):
            assert set(rank[kind]) == set(want[kind])
            assert rank[kind]["n"] == want[kind]["n"] > 0
            for k, v in want[kind].items():
                assert abs(rank[kind][k] - v) < EVAL_TOL, (kind, k)
                assert abs(rank[kind][k] - got[0][f"host_{kind}"][k]) \
                    < EVAL_TOL, (kind, k)


def test_dp_tp_step_matches_jit_train_step(jobs):
    got, (jm, want) = jobs("train")
    for rank in got:
        for k in ("loss", "loss_mask", "sam_loss_dice", "aiou", "grad_norm"):
            np.testing.assert_allclose(rank["metrics"][k], float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree_util.tree_leaves(rank["trainable"])):
            np.testing.assert_allclose(g, w, atol=TREE_TOL, rtol=TREE_TOL,
                                       err_msg=str(path))
        assert rank["metrics"] == got[0]["metrics"]


@pytest.mark.parametrize("variant, mode", FORWARD_CASES)
def test_model_parallel_forward_matches_jax(jobs, variant, mode):
    """The split forward against the JAX forward of the same weights and
    batch (1e-3) and against the one-rank forward on the same rank (tp
    1e-3, fsdp bit for bit)."""
    got, want = jobs(variant)
    assert got[2] is None and got[3] is None  # outside the 1 x 2 mesh
    assert set(KEYS) <= set(want)
    for rank in got[:2]:
        assert rank["kinds"]["llm"] == "ShardedTree"
        assert rank["kinds"]["sam_encoder"] == (
            "ShardedTree" if mode == "tp" else "dict")
        for k in KEYS + ("lm_logits",):
            if mode == "fsdp":  # whole layers, broadcast: the same numbers
                np.testing.assert_array_equal(rank["sharded"][k],
                                              rank["one_rank"][k], err_msg=k)
            np.testing.assert_allclose(rank["sharded"][k],
                                       rank["one_rank"][k], atol=FORWARD_TOL,
                                       rtol=FORWARD_TOL, err_msg=k)
            np.testing.assert_array_equal(rank["sharded"][k],
                                          got[0]["sharded"][k], err_msg=k)
            if k in want:
                np.testing.assert_allclose(rank["sharded"][k], want[k],
                                           atol=FORWARD_TOL,
                                           rtol=FORWARD_TOL, err_msg=k)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_pipeline_matches_jax(jobs, moe):
    runs, want = jobs(f"pipeline_{moe}")
    for n_mb, got in runs:
        for rank in got[:2]:
            for key in ("attn", "hidden", "last_hidden"):
                np.testing.assert_allclose(
                    rank[key], np.asarray(want[key]), atol=PIPELINE_ATOL,
                    err_msg=f"{key} n_mb={n_mb}")


def test_pipeline_refuses_what_does_not_divide():
    from flmm_tpu_torch.parallel import pipeline as pp

    class OneStage:  # a mesh of one rank on the model axis
        shape, mesh_dim_names = (1, 3), ("data", "model")

        def get_group(self, _):
            return None

        def get_local_rank(self, _):
            return 0

    from flmm_tpu_torch.models.llm.decoder import DecoderConfig

    cfg = DecoderConfig(vocab_size=8, hidden_size=8, num_layers=4,
                        num_heads=2, num_kv_heads=2, head_dim=4,
                        intermediate_size=8, dtype=torch.float32)
    x = torch.zeros((4, 3, 8))
    with pytest.raises(ValueError, match="stages"):
        pp.pipeline_forward_capture({}, cfg, x, torch.ones((4, 3)), 0, 1,
                                    mesh=OneStage())
    OneStage.shape = (1, 2)
    with pytest.raises(ValueError, match="microbatches"):
        pp.pipeline_forward_capture({}, cfg, x, torch.ones((4, 3)), 0, 1,
                                    mesh=OneStage(), n_microbatches=3)


def _refiner_case():
    """The tiny refiner with multimask output on random embeddings, coarse
    logits, geometry and text (weights: the port's init)."""
    params = _params("dense", 2)["trainable"]["sam"]
    g = jtiny().sam.prompt.image_embedding_size
    d = jtiny().sam.prompt.embed_dim
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((g, g, d)).astype(np.float32)
    coarse = (rng.standard_normal((3, 16, 16)) * 3).astype(np.float32)
    geom = {k: np.float32(v) for k, v in dict(
        crop_y=2, crop_x=1, crop_h=12, crop_w=14, sam_h=96, sam_w=112).items()}
    text = rng.standard_normal((3, 2, d)).astype(np.float32)
    valid = np.array([[True, True], [True, False], [True, True]])
    return params, emb, coarse, geom, text, valid


def _jax_refine(params, emb, coarse, geom, text, valid):
    from flmm_tpu.models.mask_head import refiner as jrefiner

    cfg = dataclasses.replace(jtiny().sam, multimask_output=True)
    return jax.device_get(jax.jit(
        lambda *a: jrefiner.refine(a[0], cfg, *a[1:]))(
        _jnp(params), emb, coarse, geom, text, valid))


def test_refiner_multimask_matches_jax(jobs):
    from flmm_tpu_torch.configs.deepseek_vl import tiny
    from flmm_tpu_torch.models.mask_head import refiner

    (params, emb, coarse, geom, text, valid), want = jobs("refiner")
    cfg = dataclasses.replace(tiny().sam, multimask_output=True)
    got = refiner.refine(from_jax(params), cfg, torch.from_numpy(emb),
                         torch.from_numpy(coarse),
                         {k: torch.tensor(v) for k, v in geom.items()},
                         torch.from_numpy(text), torch.from_numpy(valid))
    for k in ("low_res_logits", "iou_pred", "prompt_masks", "boxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=REFINER_TOL, rtol=REFINER_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("form", SEQ_FORMS)
@pytest.mark.parametrize("case", SEQ_CASES)
def test_sequence_sharded_forward_matches_jax(jobs, case, form):
    """Each model rank returns the whole outputs of its data rows: equal
    on both, 1e-5 of the one-rank forward, 1e-3 of the JAX forward under
    the sequence constraint."""
    got, want = jobs(f"seq_{case}")
    want = want[form]
    for key in ("attn", "hidden", "last_hidden"):
        for rank in got:
            np.testing.assert_allclose(
                rank[form]["sharded"][key], rank[form]["one_rank"][key],
                atol=SEQ_ONE_RANK_TOL, rtol=SEQ_ONE_RANK_TOL, err_msg=key)
        for d in (0, 2):  # data rank d // 2: model ranks d and d + 1
            np.testing.assert_array_equal(got[d][form]["sharded"][key],
                                          got[d + 1][form]["sharded"][key])
        whole = np.concatenate([got[0][form]["sharded"][key],
                                got[2][form]["sharded"][key]])
        assert whole.shape == want[key].shape, key
        np.testing.assert_allclose(whole, np.asarray(want[key]),
                                   atol=FORWARD_TOL, rtol=FORWARD_TOL,
                                   err_msg=key)
    if form == "max":  # a mask with no row: 0, as the one-rank forward
        assert (got[0][form]["sharded"]["attn"] >= 0).all()
    # K5 (its plain twin) on each model rank's rows in the aligned case,
    # for the mean form only; none at S = 99
    offsets = [rank["k5_offsets"] for rank in got]
    if case == "aligned":
        # the sharded forward's 4 layers, then the one-rank forward's
        assert offsets == [[0] * 8, [128] * 4 + [0] * 4] * 2
    else:
        assert offsets == [[]] * 4


@pytest.mark.parametrize("what", ["tp", "kv_cache", "unaligned_k5"])
def test_sequence_sharding_refuses(what):
    """Refused before any collective: a tp tree, a KV cache, K5 on chunks
    that are not multiples of 128 rows (S = 384 over 2 ranks: 192)."""
    from flmm_tpu_torch.configs.deepseek_vl import tiny
    from flmm_tpu_torch.parallel.frozen import ShardedTree
    from flmm_tpu_torch.parallel.mesh import Axis

    S = 384 if what == "unaligned_k5" else 256
    cfg = dataclasses.replace(tiny(img_start=128).llm, num_layers=1,
                              use_flash_capture=True)
    params = tdecoder.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    x = torch.zeros((1, S, cfg.hidden_size))
    mask = torch.ones((1, S), dtype=torch.bool)
    kw = dict(img_start=128, n_img=64, seq_axis=Axis(None, 2, 0),
              merge_matrix=torch.ones((1, S, 2)) / S)
    if what == "tp":
        params = ShardedTree(params, "tp", Axis(None, 2, 0), {})
        kw["merge_matrix"] = None
        match = "tensor-parallel"
    elif what == "kv_cache":
        kw["kv_cache"] = (torch.zeros((1, 1, S, cfg.num_kv_heads,
                                       cfg.head_dim)),) * 2
        match = "KV cache"
    else:
        match = "chunks of 192"
    with pytest.raises((ValueError, NotImplementedError), match=match):
        tdecoder.forward_capture(params, cfg, x, mask, **kw)
