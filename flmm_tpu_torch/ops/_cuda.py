"""Build and bind the port's CUDA kernels (``flmm_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, then linked into one shared
library with a plain C interface, cached under ``build/`` at the root of the
checkout by a digest of the sources and flags, and loaded with ``ctypes``.
The wgmma + TMA kernels encode their tensor maps with the driver's
``cuTensorMapEncodeTiled``, which csrc/sm90.cuh fetches at run time through
``cudaGetDriverEntryPoint``: the library links the CUDA runtime only, no
``-lcuda``.  Nothing here runs at import time; a refused or failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[2] / "build" / "flmm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # A, M, K, ln_w, ln_b, eps, row_valid, B, N, bias, out, ln_out, stream
    "flmm_ln_gemm": (_P, _I, _I, _P, _P, _F, _P, _P, _I, _P, _P, _P, _P),
    # shortcut, attn, N, C, F, wo, bo, ln_w, ln_b, eps, w1, b1, w2, b2, act,
    # out, x_f32, ln, h, stream
    "flmm_block_tail": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _F, _P, _P, _P,
                        _P, _I, _P, _P, _P, _P, _P),
    # q, q_b, q_h, q_t, k, v, s_b, s_h, s_t, nh, bias, table_h, table_w,
    # side, G, S, softmax, alpha, out, o_b, o_h, o_t, stream
    "flmm_relpos_attention_sm90": (_P, _L, _L, _L, _P, _P, _L, _L, _L, _I, _P,
                                   _P, _P, _I, _I, _I, _I, _F, _P, _L, _L, _L,
                                   _P),
    # x, N, C, F, ln_w, ln_b, eps, w1, b1, w2, b2, act, out, ln, h, stream
    "flmm_ln_mlp": (_P, _I, _I, _I, _P, _P, _F, _P, _P, _P, _P, _I, _P, _P,
                    _P, _P),
    # A, M, K, B, N, bias, resid, out (f32), stream
    "flmm_gemm_residual_f32": (_P, _I, _I, _P, _I, _P, _P, _P, _P),
    # q, q_b, q_h, q_t, k, k_b, k_h, k_t, v, v_b, v_h, v_t, nh, G, S,
    # head_dim, scale, out, o_b, o_h, o_t, stream
    "flmm_plain_flash": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _I,
                         _I, _I, _I, _F, _P, _L, _L, _L, _P),
    # q, q_b, q_h, q_t, k, k_b, k_h, k_t, v, v_b, v_h, v_t, B, H, KV, S, Sq,
    # q_off, head_dim, key_valid, mm, M, img_start, n_img, out, o_b, o_h,
    # o_t, lse, flags, merged, stream
    "flmm_flash_capture": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L,
                           _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I,
                           _P, _L, _L, _L, _P, _P, _P, _P),
    # q, q_b, q_h, q_t, k, k_b, k_h, k_t, v, v_b, v_h, v_t, B, H, KV, S,
    # head_dim, key_valid, img_start, n_img, out, o_b, o_h, o_t, lse, probs,
    # stream
    "flmm_flash_capture_raw": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L,
                               _I, _I, _I, _I, _I, _P, _I, _I, _P, _L, _L,
                               _L, _P, _P, _P),
    # x, out, B, H, W, Hp, Wp, ws, 16-byte vectors per token, stream
    "flmm_windowize": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "flmm_dewindowize": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, q_b, q_h, q_t, k, v, s_b, s_h, s_t, nh, table_h, table_w, side, G,
    # T, mode, out, o_b, o_h, o_t, stream
    "flmm_window_attention_sm90": (_P, _L, _L, _L, _P, _P, _L, _L, _L, _I,
                                   _P, _P, _I, _I, _I, _I, _P, _L, _L, _L,
                                   _P),
    # qkv, table_h, table_w, B, Hp, Wp, nh, side, grid_hw, alpha, out, stream
    "flmm_spatial_window_attention_sm90": (_P, _P, _P, _I, _I, _I, _I, _I,
                                           _I, _F, _P, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled kernel library, built on the first call."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode() + f.read_bytes())
    so = BUILD / f"libflmm_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD / f"{src.stem}_{tag}.o" for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources, objs)]
        errs = [proc.communicate()[1] for proc in procs]
        # ptxas' register / shared-memory / spill report per kernel
        (BUILD / "ptxas.log").write_text("".join(
            f"== {src.name}\n{err}" for src, err in zip(sources, errs)))
        for src, proc, err in zip(sources, procs, errs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} with code "
                                   f"{proc.returncode}:\n{err}")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        for obj in objs:
            obj.unlink()
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed with code {link.returncode}:\n"
                f"{link.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.flmm_error_string.argtypes = (ctypes.c_int,)
    lib.flmm_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if the launch reported an error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.flmm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> None:
    """Every tensor a kernel reads: on one CUDA device, of ``dtype``,
    contiguous and 16-byte aligned (the kernels load 16-byte vectors)."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: argument {i} is on {t.device}, "
                             f"expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: argument {i} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: argument {i} is not 16-byte aligned")


def check_no_grad(name: str, *tensors) -> None:
    """Raise when autograd would have to differentiate through a kernel: the
    kernels have no backward, so a CUDA launch would cut the gradient that
    the plain version gives on the CPU.  Checked on every device."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no backward; "
            "call it under torch.no_grad() or on inputs that need no grad")
