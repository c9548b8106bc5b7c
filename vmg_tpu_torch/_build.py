"""Build the hand-written CUDA kernels and bind them with ctypes.

``csrc/*.cu`` compile with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
per source, all started together, and link into one shared library with a
plain C interface, at first use, under ``_build/`` (listed in
``.gitignore``).  The library's file name carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale one is never
loaded.  Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into
an exception.  The library links only the CUDA runtime: the conv chain's
TMA tensor maps come from ``cuTensorMapEncodeTiled``, which it looks up
at run time through ``cudaGetDriverEntryPoint`` (no ``-lcuda``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # x, w, b1, b2, out, N, H, W, C, G, fgp, act, dtype, stream
    "vmg_group_ffn": [_P] * 5 + [_I] * 8 + [_P],
    # h, w, c, partial, out, N, P, C, S, per, vec, dtype, stream
    "vmg_morphfc_reduce": [_P] * 5 + [_I] * 7 + [_P],
    # x, h, w, c, a, pk, pb, res, out, N, P, C, res_scale, act, nwg, ring,
    # dtype, stream
    "vmg_morphfc_combine": [_P] * 9 + [_I] * 3 + [_F] + [_I] * 4 + [_P],
    # x, c, kh, bh, kw, bw, h, w, partial, psum, scratch (or null), N, H, W,
    # C, ch, cw, WT, nwg, ring, npass, grid, dtype, stream
    "vmg_morphfc_axes": [_P] * 11 + [_I] * 12 + [_P],
    # x, c, kh, bh, kw, bw, h, w, img, bimg, partial, psum, plan (or null),
    # N, H, W, C, ch, cw, WT, dtype, stream (the token form)
    "vmg_morphfc_axes_token": [_P] * 13 + [_I] * 8 + [_P],
    # q, kv, pe, out, den (or null), N, H, W, C, K, heads, Wt, HB, dtype,
    # stream
    "vmg_ltam_fwd": [_P] * 5 + [_I] * 9 + [_P],
    # q, kv, pe, den, out, g, dq, dkv, dpe, partial, N, H, W, C, K, heads,
    # Wt, HB, nbuf, dtype, stream
    "vmg_ltam_bwd": [_P] * 10 + [_I] * 10 + [_P],
    # x, scale, bias (or null), out, rows, C, eps, rms, dtype, stream
    "vmg_fused_norm": [_P] * 4 + [_L, _I, _F, _I, _I, _P],
    # H, W, dtype -> output tiles per frame
    "vmg_conv_chain_tiles": [_I] * 3,
    # x, w1, b1, w2, b2, out, mid (bf16 scratch, or null), partial, psum
    # (or both null), N, H, W, Cin, Cinp, Cm, Cout, Coutp, act, has_res,
    # res_scale, dtype, stream
    "vmg_conv_chain": [_P] * 9 + [_I] * 10 + [_F, _I, _P],
    # x, out, bytes, stream
    "vmg_layout_pin": [_P, _P, _L, _P],
    # x, out, Wp, C, R, slabs, wpiece, stream
    "vmg_probe_slab_copy": [_P] * 2 + [_I] * 5 + [_P],
    # in, out, A, Bin, Cin, Bout, Cout, kind, p0, p1, rows, threads, stage,
    # smem, stream
    "vmg_probe_relayout": [_P] * 2 + [_I] * 12 + [_P],
    # a, b, out, M, N, K, taps, batch, reps, kind, lda, tap_stride,
    # batch_stride, Wo, Wx, Cx, cg, stride, arows, nt, kw, kbox, ring, grid,
    # tma, stream
    "vmg_probe_tile_gemm": [_P] * 3 + [_I] * 22 + [_P],
}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _library_path() -> Path:
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libvmg_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing.
    Returns its path; raises with nvcc's output if compilation fails."""
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cu, _ = _sources()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in cu]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=_CSRC)
             for src, obj in zip(cu, objs)]
    logs = [p.communicate()[0] for p in procs]
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=_CSRC)
        logs.append(link.stdout)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        failed = [str(src) for src, p in zip(cu, procs) if p.returncode] or ["link"]
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n" + "".join(logs))
    os.replace(tmp, so)
    text = "".join(logs).strip()
    if text:
        print(text)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vmg_error_string.argtypes = [ctypes.c_int]
    lib.vmg_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = load_library().vmg_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the persistent
    kernels' grid)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, shape=None, dtype=None,
            device=None) -> None:
    """Validate a kernel operand: CUDA, contiguous, dtype, shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if dtype is None and t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} has dtype {t.dtype}; kernels take float32 "
                         "or bfloat16")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
