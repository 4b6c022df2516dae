"""Orbax checkpoints of the JAX trainer, read without orbax, tensorstore,
zstandard or JAX (flmm_tpu/train/checkpoint.py writes them through
``ocp.StandardCheckpointer``).

Such a directory holds an OCDBT key-value store: a ``manifest.ocdbt`` at
its root, or one under each ``ocdbt.process_<i>/`` (orbax 0.11 writes both:
each process its own, then a root manifest that refers to the process
files).  A manifest names the newest version's B-tree root; its leaves map
keys to values, inline (at most ``max_inline_value_bytes``) or indirect (a
data file, an offset and a length).  Every manifest and node ends with a
CRC-32C of what precedes it and is zstd-compressed when its header says so.
The keys are a zarr v2 store per array: ``<name>/.zarray`` (shape, chunks,
dtype, order, fill value, compressor, separator) and one key per stored
chunk, ``<name>/0.0`` ...; a chunk that equalled the fill value may be
absent.  Array names are the tree paths joined by dots:
``params.sam.decoder.hyper_mlps.0.0.w``.

Only ``params.*`` arrays are read; ``opt_state.*`` and ``step`` are listed
and never decompressed.  zstd and CRC-32C come from the host library
(runtime/zstd_decode.cpp).
"""

from __future__ import annotations

import json
import pathlib
import struct

import numpy as np
import torch

from flmm_tpu_torch import runtime

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
# zarr v2 dtypes of the trees the trainer saves (f32 or bf16 params, int32
# counters) -> (numpy, torch); bf16 goes through its bit pattern
_ZARR_DTYPES = {
    "<f4": (np.float32, torch.float32),
    "<i4": (np.int32, torch.int32),
    "bfloat16": (np.uint16, torch.bfloat16),
}


def is_orbax_dir(path) -> bool:
    """Whether ``path`` is a directory the JAX trainer's checkpointer
    wrote (its metadata files or an OCDBT manifest)."""
    p = pathlib.Path(path)
    if not p.is_dir():
        return False
    names = ("_METADATA", "_CHECKPOINT_METADATA", MANIFEST)
    return (any((p / n).exists() for n in names)
            or any(p.glob(f"ocdbt.process_*/{MANIFEST}")))


class _Reader:
    """Varints, bytes and fixed-width integers off a buffer."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")

    def u8(self) -> int:
        self.need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def raw(self, n: int) -> bytes:
        self.need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def column(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes left over")


def _unwrap(data: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file: magic, length, version,
    compression, body, CRC-32C; the body decompressed."""
    if len(data) < 18:
        raise ValueError(f"{what}: too short for an OCDBT header")
    got_magic, length = struct.unpack(">I", data[:4])[0], struct.unpack(
        "<Q", data[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{what}: not an OCDBT file (magic {got_magic:#x})")
    if length != len(data):
        raise ValueError(f"{what}: header says {length} bytes, has "
                         f"{len(data)}")
    want = struct.unpack("<I", data[-4:])[0]
    if runtime.crc32c(data[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise ValueError(f"{what}: unknown OCDBT format version {version}")
    compression = r.u8()
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return runtime.zstd_decompress(body, what)
    raise ValueError(f"{what}: unknown compression id {compression}")


def _data_files(r: _Reader) -> list:
    """The data file table: paths sharing prefixes with the one before,
    each split into a base path and a relative path."""
    n = r.varint()
    prefix = [0] + r.column(n - 1) if n else []
    suffix, base = r.column(n), r.column(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: bad data file table")
        path = prev[:prefix[i]] + r.raw(suffix[i])
        prev = path
        out.append(path.decode())
    if any(b > len(p) for b, p in zip(base, out)):
        raise ValueError(f"{r.what}: bad data file table")
    return out


class OcdbtStore:
    """The newest version of an OCDBT store under ``root``: keys and
    values, read from the files on first use."""

    def __init__(self, root: pathlib.Path):
        self.root = root
        path = root / MANIFEST
        what = str(path)
        r = _Reader(_unwrap(path.read_bytes(), MANIFEST_MAGIC, what), what)
        r.raw(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{what}: manifest kind {kind} (numbered "
                             "manifests) is not supported")
        self.max_inline = r.varint()
        self.max_node_bytes = r.varint()
        r.u8()  # version tree arity (log2)
        compression = r.varint()
        if compression == 1:
            r.raw(4)  # zstd level, i32
        elif compression != 0:
            raise ValueError(f"{what}: unknown compression id {compression}")
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            raise ValueError(f"{what}: no version")
        r.column(n)  # generation numbers
        heights = [r.u8() for _ in range(n)]
        fid, off, length, num_keys = (r.column(n), r.column(n), r.column(n),
                                      r.column(n))
        r.column(n)  # tree bytes
        r.column(n)  # indirect value bytes
        r.raw(8 * n)  # commit times, u64 each
        # references to older versions' tree nodes follow; the newest
        # version is always inline
        if num_keys[-1] == 0:
            self.root_ref = None
        else:
            if fid[-1] >= len(files):
                raise ValueError(f"{what}: root names data file {fid[-1]}")
            self.root_ref = (files[fid[-1]], off[-1], length[-1], heights[-1])
        self._entries = None

    def _file(self, rel: str, offset: int, length: int) -> bytes:
        path = self.root / rel
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} run past "
                             "the end")
        return data

    def _node(self, ref, prefix: bytes, height: int, out: dict) -> None:
        rel, offset, length = ref[:3]
        what = f"{self.root / rel} (node at {offset})"
        body = _unwrap(self._file(rel, offset, length), NODE_MAGIC, what)
        if len(body) > self.max_node_bytes:
            raise ValueError(f"{what}: node of {len(body)} bytes above the "
                             f"configured {self.max_node_bytes}")
        r = _Reader(body, what)
        if r.u8() != height:
            raise ValueError(f"{what}: height differs from its parent's")
        files = _data_files(r)
        n = r.varint()
        prefix_len = [0] + r.column(n - 1) if n else []
        suffix_len = r.column(n)
        common = r.column(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            key = prev[:prefix_len[i]] + r.raw(suffix_len[i])
            prev = key
            keys.append(key)
        if height == 0:
            value_len = r.column(n)
            kinds = r.column(n)
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f"{what}: unknown value kind")
            indirect = [i for i in range(n) if kinds[i] == 1]
            fid, off = r.column(len(indirect)), r.column(len(indirect))
            for i in range(n):
                if kinds[i] == 0:
                    out[prefix + keys[i]] = r.raw(value_len[i])
            for j, i in enumerate(indirect):
                if fid[j] >= len(files):
                    raise ValueError(f"{what}: value names data file "
                                     f"{fid[j]}")
                out[prefix + keys[i]] = (files[fid[j]], off[j], value_len[i])
        else:
            fid, off, length = r.column(n), r.column(n), r.column(n)
            for _ in range(3):  # keys, tree bytes, indirect value bytes
                r.column(n)
            for i in range(n):
                if fid[i] >= len(files):
                    raise ValueError(f"{what}: child names data file "
                                     f"{fid[i]}")
                self._node((files[fid[i]], off[i], length[i]),
                           prefix + keys[i][:common[i]], height - 1, out)
        r.done()

    def entries(self) -> dict:
        """``key -> inline bytes or (data file, offset, length)``."""
        if self._entries is None:
            self._entries = {}
            if self.root_ref is not None:
                self._node(self.root_ref, b"", self.root_ref[3],
                           self._entries)
        return self._entries

    def read(self, key: bytes) -> bytes:
        value = self.entries()[key]
        if isinstance(value, bytes):
            return value
        return self._file(*value)


def open_store(path) -> list:
    """The stores of an Orbax directory: its root manifest's, else each
    process's."""
    p = pathlib.Path(path)
    if (p / MANIFEST).exists():
        return [OcdbtStore(p)]
    procs = sorted(p.glob(f"ocdbt.process_*/{MANIFEST}"))
    if not procs:
        raise FileNotFoundError(f"{p}: no {MANIFEST} at its root or under "
                                "ocdbt.process_<i>/")
    return [OcdbtStore(m.parent) for m in procs]


class ZarrArrays:
    """The zarr v2 arrays of an Orbax directory, by name."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.stores = open_store(path)
        self.where = {}
        for store in self.stores:
            for key in store.entries():
                name, _, rest = key.rpartition(b"/")
                if name:
                    self.where.setdefault(name.decode(), store)

    def names(self) -> list:
        return sorted(n for n in self.where
                      if (n.encode() + b"/.zarray") in
                      self.where[n].entries())

    def read(self, name: str) -> torch.Tensor:
        """One array, whole, as a CPU tensor."""
        store = self.where.get(name)
        what = f"{self.path}: {name}"
        if store is None:
            raise KeyError(f"{what}: no such array")
        meta = json.loads(store.read(name.encode() + b"/.zarray"))
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{what}: zarr format {meta.get('zarr_format')}")
        if meta.get("filters"):
            raise ValueError(f"{what}: zarr filters are not supported")
        if meta["dtype"] not in _ZARR_DTYPES:
            raise ValueError(f"{what}: zarr dtype {meta['dtype']!r} is not "
                             "supported")
        np_dtype, t_dtype = _ZARR_DTYPES[meta["dtype"]]
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise ValueError(f"{what}: compressor {comp.get('id')!r} is not "
                             "supported")
        shape, chunks = list(meta["shape"]), list(meta["chunks"])
        order = meta.get("order", "C")
        sep = meta.get("dimension_separator", ".")
        out = np.empty(shape, np_dtype)
        out[...] = self._fill(meta.get("fill_value"), np_dtype, what)
        grid = [-(-s // c) for s, c in zip(shape, chunks)]
        entries = store.entries()
        for idx in np.ndindex(*grid):
            key = (name + "/" + (sep.join(map(str, idx)) if idx else "0")
                   ).encode()
            if key not in entries:
                continue  # a chunk equal to the fill value
            raw = store.read(key)
            if comp is not None:
                raw = runtime.zstd_decompress(raw, f"{what} chunk {key!r}")
            want = int(np.prod(chunks)) * np.dtype(np_dtype).itemsize
            if len(raw) != want:
                raise ValueError(f"{what}: chunk {key!r} holds {len(raw)} "
                                 f"bytes, not {want}")
            chunk = np.frombuffer(raw, np_dtype).reshape(chunks, order=order)
            sl = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
            out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
        t = torch.from_numpy(out)
        if t_dtype == torch.bfloat16:
            t = t.view(torch.int16).view(torch.bfloat16)
        return t

    @staticmethod
    def _fill(value, np_dtype, what: str):
        if value is None:
            return 0
        if np_dtype == np.uint16:  # bfloat16 through its bit pattern
            f32 = np.array(float(value), np.float32).view(np.uint32)
            return (f32 >> 16).astype(np.uint16)
        if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
            return float(value)
        return value


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def read_params(path, template: dict) -> dict:
    """The ``params`` subtree of an Orbax train state, as CPU tensors in
    ``template``'s structure (a nested dict / list of tensors); each
    array's shape must be the template's.  The names of the store's
    ``params.*`` arrays must be exactly the template's."""
    arrays = ZarrArrays(path)
    have = {n for n in arrays.names() if n.startswith("params.")}
    want = {"params." + ".".join(p): p for p, _ in _paths(template)}
    if have != set(want):
        missing, extra = sorted(set(want) - have), sorted(have - set(want))
        raise ValueError(f"{path}: the checkpoint's params differ from the "
                         f"trainable tree: missing {missing[:5]}, extra "
                         f"{extra[:5]}")

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        name = "params." + ".".join(prefix)
        t = arrays.read(name)
        if tuple(t.shape) != tuple(tree.shape):
            raise ValueError(f"{path}: {name} has shape {tuple(t.shape)}, "
                             f"the trainable tree {tuple(tree.shape)}")
        return t

    return build(template, ())
