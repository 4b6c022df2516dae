"""The PIL-free, JAX-free Orbax reader: runtime/zstd_decode.cpp against
``zstandard``, convert/orbax.py's OCDBT and zarr v2 reading against
``tensorstore``, and ``train.checkpoint.restore_trainable`` on states that
``flmm_tpu.train.checkpoint.save`` wrote against
``flmm_tpu.train.checkpoint.restore_trainable``, bit for bit.  The package
imports none of orbax, tensorstore or zstandard (test_torch_guards.py)."""

import hashlib
import json
import pathlib
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import tensorstore as ts
import torch
import zstandard

from flmm_tpu.configs import deepseek_vl as jax_configs
from flmm_tpu.models.frozen import grounding as jgrounding
from flmm_tpu.train import checkpoint as jcheckpoint
from flmm_tpu.train import loop as jloop
from flmm_tpu_torch import runtime
from flmm_tpu_torch.configs import deepseek_vl as torch_configs
from flmm_tpu_torch.convert import orbax
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.train import checkpoint

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _corpus():
    """Buffers from 0 B to 4.5 MB: empty, one byte, random bytes, long
    runs, text, float32 arrays, and a mix.  Across the three levels they
    take raw, RLE and compressed blocks; raw, RLE, compressed (1 and 4
    streams, weights direct and FSE-coded) and treeless literals; the
    predefined, RLE, FSE and repeat modes of the sequence tables; and all
    four repeat-offset cases (counted with an instrumented build of the
    decoder)."""
    rng = np.random.default_rng(0)
    text = (pathlib.Path(__file__).read_bytes() * 8)[:300_000]
    floats = (np.sin(np.arange(250_000) / 7.0) * 100).astype(
        np.float32).tobytes()
    mix = b"".join([rng.bytes(200_000), b"\x00" * 300_000, text,
                    floats, bytes(rng.integers(0, 4, 500_000,
                                               dtype=np.uint8)),
                    b"abcd" * 100_000])
    # pieces of a random string joined by one byte: blocks whose literals
    # are that byte alone (RLE literals)
    pieces = rng.bytes(4000)
    joined = pieces + b"".join(pieces[o:o + 60] + b"z"
                               for o in rng.integers(0, 3900, 6000))
    return [b"", b"x", rng.bytes(100), rng.bytes(5000), b"\x07" * 70_000,
            text, floats, joined, (mix * 3)[:4_500_000]]


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("checksum, size", [(True, True), (False, False),
                                            (True, False), (False, True)])
def test_zstd_matches_zstandard(level, checksum, size):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=size)
    for data in _corpus():
        if level == 19 and len(data) > 1_000_000 and not (checksum and size):
            continue  # the 4.5 MB buffer at level 19 once: 3 s to compress
        frame = c.compress(data)
        assert runtime.zstd_decompress(frame) == data, len(data)


def test_zstd_frames_without_size_skippable_and_several():
    rng = np.random.default_rng(1)
    a, b = rng.bytes(70_000) + b"z" * 90_000, b"hello " * 5000
    streamed = zstandard.ZstdCompressor(level=3).compressobj()
    no_size = streamed.compress(a) + streamed.flush()  # no content size
    skippable = b"\x5a\x2a\x4d\x18" + (7).to_bytes(4, "little") + b"1234567"
    both = no_size + skippable + zstandard.ZstdCompressor(
        level=19, write_checksum=True).compress(b)
    assert runtime.zstd_decompress(both) == a + b
    assert runtime.zstd_decompress(skippable) == b""


def test_zstd_refusals_name_what_failed():
    data = b"checked " * 1000
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(data))
    frame[-1] ^= 0xFF
    with pytest.raises(ValueError, match="content checksum mismatch"):
        runtime.zstd_decompress(bytes(frame), "f.zst")
    with pytest.raises(ValueError, match="f.zst: not zstd data"):
        runtime.zstd_decompress(b"nope" * 4, "f.zst")
    with pytest.raises(ValueError, match="truncated"):
        runtime.zstd_decompress(bytes(frame[:20]))
    d = zstandard.ZstdCompressionDict(b"dictionary content " * 100,
                                      dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    d.precompute_compress(level=3)
    with_dict = zstandard.ZstdCompressor(dict_data=d, write_dict_id=True)
    frame = with_dict.compress(b"dictionary content and more " * 50)
    if frame[4] & 3:  # the frame names its dictionary
        with pytest.raises(ValueError, match="needs dictionary"):
            runtime.zstd_decompress(frame)
    else:  # a raw-content dictionary has no id: its back-references fail
        with pytest.raises(ValueError, match="corrupt data"):
            runtime.zstd_decompress(frame)


def test_checksums():
    assert runtime.crc32c(b"123456789") == 0xE3069283
    assert runtime.crc32c(b"") == 0
    assert runtime.xxh64(b"") == 0xEF46DB3751D8E999
    assert runtime.xxh64(b"abc") == 0x44BC2CF5AD770999
    # the low 32 bits of XXH64 are zstd's content checksum
    data = np.random.default_rng(2).bytes(100_003)
    frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
    assert runtime.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:],
                                                              "little")


def _trainable(bf16_leaf=True):
    jcfg = jax_configs.tiny()
    tra = jax.device_get(jax.jit(lambda k: jgrounding.init_params(jcfg, k))(
        jax.random.key(3)))["trainable"]
    if bf16_leaf:  # 1024 elements, 2 KB: an indirect bf16 value
        tra["text_proj"]["w"] = tra["text_proj"]["w"].astype(jnp.bfloat16)
    return jcfg, tra


@pytest.fixture(scope="module")
def jax_state(tmp_path_factory):
    """A train state of the JAX trainer at the tiny preset (params with a
    bf16 leaf, AdamW moments, step), written by its own ``save``."""
    jcfg, tra = _trainable()
    path = tmp_path_factory.mktemp("orbax") / "step_7"
    opt = jloop.make_optimizer(jloop.OptimConfig())
    state = jloop.init_state(jax.tree.map(jnp.asarray, tra), opt)
    state["step"] = jnp.int32(7)
    jcheckpoint.save(path, state)
    return jcfg, tra, path


def _kv(path):
    return ts.KvStore.open({"driver": "file",
                            "path": str(path) + "/"}).result()


@pytest.mark.parametrize("where", ["root", "ocdbt.process_0"])
def test_manifest_and_nodes_match_tensorstore(jax_state, where):
    _, _, path = jax_state
    root = path if where == "root" else path / where
    dump = ts.ocdbt.dump(_kv(root)).result()
    store = orbax.OcdbtStore(root)
    newest = dump["versions"][-1]
    loc = newest["root"]["location"]  # btreenode::<file>:<offset>:<length>
    rel, off, length = loc.split("::", 1)[1].rsplit(":", 2)
    assert store.root_ref == (rel, int(off), int(length),
                              newest["root_height"])
    assert store.max_inline == dump["config"]["max_inline_value_bytes"]
    node = ts.ocdbt.dump(_kv(root), loc).result()
    entries = store.entries()
    assert len(entries) == newest["root"]["statistics"]["num_keys"]
    for e in node["entries"]:
        got = entries[e["key"]]
        if "inline_value" in e:
            assert got == e["inline_value"]
        else:
            # value:<base path>:<relative path>:<offset>:<length>
            base, rel, off, length = e["indirect_value"].split(":", 1)[
                1].rsplit(":", 3)
            assert got == (base + rel, int(off), int(length))


def test_multilevel_tree_matches_tensorstore(tmp_path):
    """Interior nodes, subtree prefixes and shared-prefix keys: a store
    with small nodes that tensorstore writes 3 levels deep."""
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"max_decoded_node_bytes": 2048,
                   "max_inline_value_bytes": 64,
                   "compression": {"id": "zstd"}}}).result()
    want = {}
    with ts.Transaction() as txn:
        for i in range(2500):
            key = f"params.layer{i % 37}.block{i}/{i % 5}.0".encode()
            want[key] = (f"v{i}-" * (1 + i % 23)).encode()
            kv.with_transaction(txn)[key] = want[key]
    store = orbax.OcdbtStore(tmp_path)
    assert store.root_ref[3] >= 2
    assert set(store.entries()) == set(want)
    for key, value in want.items():
        assert store.read(key) == value


@pytest.mark.parametrize("spec", [
    dict(dtype="float32", shape=[37, 29], chunks=[16, 8], order="C"),
    dict(dtype="bfloat16", shape=[9, 70], chunks=[4, 32], order="C"),
    dict(dtype="int32", shape=[13, 6, 5], chunks=[5, 6, 2], order="F"),
    dict(dtype="float32", shape=[], chunks=[], order="C"),
], ids=["f32", "bf16", "i32_order_F", "scalar"])
def test_zarr_arrays_match_tensorstore(tmp_path, spec):
    """Edge chunks, F order, bf16 and a missing chunk (left at the fill
    value) through an OCDBT store, as tensorstore reads them."""
    rng = np.random.default_rng(len(spec["shape"]))
    np_dtype = {"float32": np.float32, "int32": np.int32,
                "bfloat16": jnp.bfloat16}[spec["dtype"]]
    value = (rng.normal(size=spec["shape"]) * 100).astype(np_dtype)
    arr = ts.open({
        "driver": "zarr",
        "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
        "path": "params.x",
        "metadata": {"dtype": "<f4" if spec["dtype"] == "float32" else
                     ("<i4" if spec["dtype"] == "int32" else "bfloat16"),
                     "shape": spec["shape"], "chunks": spec["chunks"],
                     "order": spec["order"], "fill_value": 3,
                     "compressor": {"id": "zstd", "level": 1}},
        "create": True}).result()
    if spec["shape"]:
        arr[1:].write(value[1:]).result()  # chunk (0, ...) keeps the fill
    else:
        arr.write(value).result()
    want = arr.read().result()
    got = orbax.ZarrArrays(tmp_path).read("params.x")
    want_t = from_jax(np.asarray(want))
    assert got.dtype == want_t.dtype and torch.equal(got, want_t)
    if spec["shape"]:
        assert (got[0].float() == 3).all()


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}/{i}")
    else:
        w = from_jax(np.asarray(want))
        assert got.dtype == w.dtype and torch.equal(got, w), where


def _template(bf16_leaf=True):
    tcfg = torch_configs.tiny()
    tra = grounding.init_trainable(tcfg, torch.Generator().manual_seed(9),
                                   "cpu")
    if bf16_leaf:
        tra["text_proj"]["w"] = tra["text_proj"]["w"].bfloat16()
    return tcfg, tra


def test_restore_trainable_equals_the_jax_restore(jax_state):
    """Every trainable leaf, carried across, bit for bit (a bf16 leaf and
    leaves above the 1024-byte inline limit among them), read into the
    template's own tensors."""
    jcfg, tra, path = jax_state
    want = jax.device_get(jcheckpoint.restore_trainable(
        path, jcfg, jax.tree.map(jnp.zeros_like, tra)))
    _assert_same(from_jax(want), tra)
    tcfg, template = _template()
    leaf = template["unet"]["enc"][3][0]["k"]
    assert leaf.numel() * 4 > 1024
    got = checkpoint.restore_trainable(path, tcfg, template)
    assert got["unet"]["enc"][3][0]["k"] is leaf  # in place
    _assert_same(got, want)


def test_restore_trainable_from_the_process_manifest(jax_state, tmp_path):
    """Without the root manifest: the per-process store gives the same
    tree."""
    jcfg, tra, path = jax_state
    copy = tmp_path / "step_7"
    shutil.copytree(path, copy)
    (copy / orbax.MANIFEST).unlink()
    assert orbax.is_orbax_dir(copy)
    assert [s.root for s in orbax.open_store(copy)] == [
        copy / "ocdbt.process_0"]
    tcfg, template = _template()
    _assert_same(checkpoint.restore_trainable(copy, tcfg, template), tra)


def test_only_params_are_decompressed(jax_state, monkeypatch):
    """``opt_state.*`` and ``step`` are listed, never decompressed."""
    _, _, path = jax_state
    arrays = orbax.ZarrArrays(path)
    names = arrays.names()
    assert "step" in names and any(n.startswith("opt_state.") for n in names)
    seen = []
    real = runtime.zstd_decompress
    monkeypatch.setattr(runtime, "zstd_decompress",
                        lambda data, what="": seen.append(what) or real(
                            data, what))
    tcfg, template = _template()
    orbax.read_params(path, template)
    chunks = [w for w in seen if "chunk" in w]
    assert chunks and all(": params." in w for w in chunks)


def test_corrupt_and_foreign_stores_raise_naming_the_file(jax_state,
                                                          tmp_path):
    _, _, path = jax_state
    copy = tmp_path / "bad"
    shutil.copytree(path, copy)
    manifest = copy / orbax.MANIFEST
    data = bytearray(manifest.read_bytes())
    data[20] ^= 1
    manifest.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"{manifest}: CRC-32C mismatch"):
        orbax.OcdbtStore(copy)
    data[20] ^= 1
    data[12] = 5  # the format version
    body = bytes(data[:-4])
    manifest.write_bytes(body + runtime.crc32c(body).to_bytes(4, "little"))
    with pytest.raises(ValueError, match=f"{manifest}: unknown OCDBT format "
                       "version 5"):
        orbax.OcdbtStore(copy)
    data[12], data[13] = 0, 7  # the compression id
    body = bytes(data[:-4])
    manifest.write_bytes(body + runtime.crc32c(body).to_bytes(4, "little"))
    with pytest.raises(ValueError, match=f"{manifest}: unknown compression "
                       "id 7"):
        orbax.OcdbtStore(copy)
    tcfg, template = _template()
    del template["text_proj"]
    with pytest.raises(ValueError, match="missing .*extra .*params.text_proj"):
        orbax.read_params(path, template)


def test_committed_fixture_state():
    """tests/data/orbax: every trainable leaf's sha256 is the one the
    fixture script recorded from the JAX tree, and the names are the
    manifest's."""
    manifest = json.loads((DATA / "manifest.json").read_text())["orbax"]
    path = DATA / manifest["path"]
    tcfg = torch_configs.tiny()
    template = grounding.init_trainable(tcfg, torch.Generator(), "cpu")
    got = orbax.read_params(path, template)
    seen = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, prefix + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, prefix + (str(i),))
        else:
            a = (tree.view(torch.int16).numpy() if tree.dtype ==
                 torch.bfloat16 else tree.numpy())
            seen[".".join(prefix)] = {
                "shape": list(tree.shape),
                "dtype": str(tree.dtype).replace("torch.", ""),
                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}

    walk(got, ())
    assert seen == manifest["leaves"]
    assert {v["dtype"] for v in seen.values()} == {"float32", "bfloat16"}
    restored = checkpoint.restore_trainable(path, tcfg, template)
    assert restored["unet"]["seg_k"].dtype == torch.float32
