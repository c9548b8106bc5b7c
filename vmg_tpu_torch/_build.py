"""Build the hand-written CUDA kernels and bind them with ctypes.

``csrc/*.cu`` compile with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
per source (three for ``morphfc.cu``, :data:`SPLITS`), all started
together, and link into one shared library with a plain C interface, at
first use, under ``_build/`` (listed in ``.gitignore``).  The library's
file name carries a hash of the sources and flags, so an edited kernel
is rebuilt and a stale one is never loaded.  Each C entry point launches
on the stream it is given and returns ``cudaGetLastError()``;
:func:`check` turns a non-zero code into an exception.  The library
links only the CUDA runtime: the conv chain's TMA tensor maps come from
``cuTensorMapEncodeTiled``, which it looks up at run time through
``cudaGetDriverEntryPoint`` (no ``-lcuda``).
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
# sources compiled more than once, one object per set of extra flags (their
# parts compile in parallel; see the note above the entry points in the source)
SPLITS = {"morphfc.cu": (("-DVMG_MORPHFC_PART=1",),
                         ("-DVMG_MORPHFC_PART=2", "-Dvmg=vmg_part2"),
                         ("-DVMG_MORPHFC_PART=3", "-Dvmg=vmg_part3"))}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # x, w, b1, b2, out, N, H, W, C, G, fgp, act, plan (bf16: the ints of
    # group_conv.ffn_plan_ints; f32: null), dtype, stream
    "vmg_group_ffn": [_P] * 5 + [_I] * 7 + [_P, _I, _P],
    # h, w, c, partial, out, N, P, C, S, per, vec, dtype, stream
    "vmg_morphfc_reduce": [_P] * 5 + [_I] * 7 + [_P],
    # x, h, w, c, a, pk, pb, res, out, N, P, C, res_scale, act, nwg, ring,
    # dtype, stream
    "vmg_morphfc_combine": [_P] * 9 + [_I] * 3 + [_F] + [_I] * 4 + [_P],
    # x, c, kh, bh, kw, bw (both null: no bias), h, w, partial, psum, scratch
    # (or null), N, H, W, C, ch, cw, WT, nwg, ring, npass, grid, relu, dtype,
    # stream
    "vmg_morphfc_axes": [_P] * 11 + [_I] * 13 + [_P],
    # x, c, kh, bh, kw, bw, h, w, img, bimg, partial, psum, plan (or null),
    # N, H, W, C, ch, cw, WT, relu, dtype, stream (the token form)
    "vmg_morphfc_axes_token": [_P] * 13 + [_I] * 9 + [_P],
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
    # x, w1, b1, w2, b2, out, mid (conv1's scratch), partial, psum (or
    # both null), N, H, W, Cin, Cinp, Cm, Cout, Coutp, act, has_res,
    # res_scale, plan (f32: conv_chain.chain_tf32_plan_ints; bf16: null),
    # dtype, stream
    "vmg_conv_chain": [_P] * 9 + [_I] * 10 + [_F, _P, _I, _P],
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
    digest = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(SPLITS.items()))).encode())
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
    units = [(src, flags) for src in cu for flags in SPLITS.get(src.name, ((),))]
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.{i}.o") for i, (src, _) in enumerate(units)]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=_CSRC)
             for (src, flags), obj in zip(units, objs)]
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
        failed = [" ".join((str(src), *flags)) for (src, flags), p in zip(units, procs)
                  if p.returncode] or ["link"]
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


# the host batch assembler (``native/packbatch.cpp``, a plain C interface):
# built with g++ beside the kernels, as the JAX package's
# ``tools/build_native.sh`` builds its own copy
_PACKBATCH_SRC = _PKG.parent / "native" / "packbatch.cpp"
HOST_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")


@functools.lru_cache(maxsize=None)
def load_packbatch() -> ctypes.CDLL:
    """Build ``native/packbatch.cpp`` under ``_build/`` if the library for
    this source and these flags is missing, and load it.  Raises if g++ is
    missing or fails."""
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode() + _PACKBATCH_SRC.read_bytes())
    so = BUILD_DIR / f"libpackbatch_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the packed-data batch assembler "
                               f"({_PACKBATCH_SRC}) is built at first use")
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        res = subprocess.run([gxx, *HOST_FLAGS, str(_PACKBATCH_SRC), "-o", str(tmp)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {_PACKBATCH_SRC}:\n{res.stdout}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))  # a CDLL call releases the GIL
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.assemble_clip.restype = ctypes.c_int
    lib.assemble_clip.argtypes = [p, i64, i64, i64, p, i64, i64, i64, i64, i64,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.assemble_batch.restype = ctypes.c_int
    lib.assemble_batch.argtypes = [p, i64, i64, i64, p, i64, i64, p, i64, i64, p]
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
