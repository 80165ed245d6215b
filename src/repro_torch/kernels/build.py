"""Build and bind the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``; all files
compile in parallel, at first use, into ``repro_torch/_build`` (listed in
``.gitignore``).  A library is named by a hash of its sources, so an edit
rebuilds it.  Nothing here runs at import: the CPU tests import every
module, and only a CUDA tensor reaches a kernel.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`call` raises when it is not ``cudaSuccess``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: C entry points: function -> (source stem, argtypes after which the
#: stream pointer follows)
SIGNATURES = {
    "intt_scale_launch": ("intt_scale",
                          [P, LL, P, P, I, I, I, I, P, P, P, P]),
    "hoist_bc_ntt_launch": ("hoist",
                            [P, P, LL, P, I, I, I, I, I, I, I, P, P, P, P, P,
                             P, P]),
    "moddown_finish_launch": ("moddown",
                              [P, LL, P, P, I, I, I, I, I, P, P, P, P, P, P,
                               P]),
    "fused_hlt_indexed_launch": ("fused_hlt",
                                 [P, P, P, P, P, P, P, P, P, P, P, P, P,
                                  I, I, I, I, I, I, P]),
    "fused_hlt_launch": ("fused_hlt",
                         [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                          P]),
    "baseconv_ntt_launch": ("hoist",
                            [P, P, P, I, I, I, I, I, P, P, P, P, P, P, P]),
    "ntt_launch": ("ntt", [P, LL, P, I, I, I, I, P, P, P]),
    "intt_launch": ("ntt", [P, LL, P, I, I, I, I, P, P, P, P]),
    "fused_hlt_batched_launch": ("fused_hlt",
                                 [P, P, P, P, P, P, P, P, P, P, P,
                                  I, I, I, I, I, I, P]),
    "baseconv_launch": ("baseconv", [P, P, P, P, P, P, P, P, P, P, I, I, I]),
    "modmul_launch": ("modmul", [P, P, P, P, P, I, I]),
    "modadd_launch": ("modmul", [P, P, P, P, I, I]),
}

_LIBS: dict = {}
BUILD_LOG: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are compiled at "
            "first use and need the CUDA toolkit (nvcc on PATH or "
            "/usr/local/cuda/bin/nvcc)")
    return path


def _lib_path(stem: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{stem}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def load() -> dict:
    """Compile (in parallel, where not built yet) and load every kernel
    library; returns {stem: ctypes.CDLL}.  Raises on a failed build."""
    if _LIBS:
        return _LIBS
    stems = sorted({s for s, _ in SIGNATURES.values()})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for stem in stems:
        lib = _lib_path(stem)
        if not lib.exists():
            tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
            procs[stem] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, lib)
    failed = []
    for stem, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[stem] = out
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (exit {proc.returncode})\n{out}")
        else:
            tmp.replace(lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    libs = {stem: ctypes.CDLL(str(_lib_path(stem))) for stem in stems}
    for fn, (stem, argtypes) in SIGNATURES.items():
        f = getattr(libs[stem], fn)
        f.argtypes = argtypes + [P]
        f.restype = I
        libs[stem].kernel_error_string.argtypes = [I]
        libs[stem].kernel_error_string.restype = ctypes.c_char_p
    _LIBS.update(libs)
    return _LIBS


def _arg(a):
    if isinstance(a, torch.Tensor):
        return a.data_ptr()
    if a is None:                       # a null pointer
        return None
    return int(a)


def call(fn: str, *args) -> None:
    """Launch ``fn`` on the current CUDA stream; raise if the launch fails."""
    stem, _ = SIGNATURES[fn]
    lib = load()[stem]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*[_arg(a) for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}: "
                           f"{lib.kernel_error_string(err).decode()}")


def check(name: str, t: torch.Tensor, dtype, rows_contiguous: bool = False):
    """A kernel operand: on CUDA, of ``dtype``, and contiguous (or, with
    ``rows_contiguous``, contiguous within each batch element)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: operand on {t.device}, the kernel needs CUDA")
    if t.dtype != dtype:
        raise TypeError(f"{name}: operand dtype {t.dtype}, want {dtype}")
    if rows_contiguous:
        ok = t.stride(-1) == 1 and t.stride(-2) == t.shape[-1]
    else:
        ok = t.is_contiguous()
    if not ok:
        raise ValueError(f"{name}: operand of shape {tuple(t.shape)} and "
                         f"strides {t.stride()} is not laid out as the "
                         f"kernel reads it")


def check_tables(name: str, device, *pairs, dtype=torch.int32):
    """(tensor, expected shape) pairs: each on ``device``, contiguous."""
    for t, shape in pairs:
        check(name, t, dtype)
        if t.device != device:
            raise ValueError(f"{name}: table on {t.device}, operand on {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: table shape {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
