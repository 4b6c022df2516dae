"""Local and remote file reads (flmm_tpu/data/io.py): ``open_any`` opens a
local path, or a ``gs://`` / ``s3://`` / ``http(s)://`` URL through fsspec
when it is installed, and raises when it is not.  ``open_image`` decodes
without PIL (data/image_io.py) to a ``(H, W, 3)`` uint8 array."""

from __future__ import annotations

import pathlib
from typing import IO

from flmm_tpu_torch.data.image_io import open_image  # noqa: F401


def _remote(path: str) -> bool:
    return "://" in path and not path.startswith("file://")


def open_any(path: str, mode: str = "rb") -> IO:
    p = str(path)
    if _remote(p):
        try:
            import fsspec
        except ImportError as e:
            raise ImportError(
                f"remote path {p!r} requires fsspec, which is not installed"
            ) from e
        return fsspec.open(p, mode).open()
    return open(p.removeprefix("file://"), mode)


def read_bytes(path: str) -> bytes:
    with open_any(path, "rb") as f:
        return f.read()


def exists(path: str) -> bool:
    p = str(path)
    if _remote(p):
        try:
            import fsspec
        except ImportError:
            return False
        fs, rel = fsspec.core.url_to_fs(p)
        return fs.exists(rel)
    return pathlib.Path(p.removeprefix("file://")).exists()
