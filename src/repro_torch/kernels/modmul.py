"""Element-wise Montgomery product and modular add over RNS limbs —
counterpart of ``repro/kernels/modmul.py`` (``modmul``, ``modadd``).

Shapes: x, y (M, N) int32 (u32 residues < q); q32 / qneg (M, 1).  Each
function has a plain PyTorch version (``core/modmath.py``, for CPU tensors
and as the on-card reference) and a CUDA kernel wrapper (``csrc/modmul.cu``,
one launch counter each).  Any N: the TPU kernel's ``block`` argument has
no counterpart, as the port's other ``ops`` entry points have no ``chunk``.
"""
from __future__ import annotations

import torch

from repro_torch.core import modmath as mm
from repro_torch.kernels import build

#: launches per kernel, counted by the wrapper right where it launches
LAUNCHES = {"modmul": 0, "modadd": 0}


def modmul_plain(x, y, q32, qneg):
    return mm.montmul(x, y, q32, qneg)


def modadd_plain(x, y, q32):
    return mm.montadd(x, y, q32)


def _launch(name, fn, x, y, *consts):
    build.check(name, x, torch.int32)
    if x.dim() != 2:
        raise ValueError(f"{name}: x of shape {tuple(x.shape)}, want (M, N)")
    M, N = x.shape
    build.check_tables(name, x.device, (y, (M, N)),
                       *[(c, (M, 1)) for c in consts])
    out = torch.empty_like(x)
    build.call(fn, x, y, *consts, out, M, N)
    LAUNCHES[name] += 1
    return out


def modmul_cuda(x, y, q32, qneg):
    return _launch("modmul", "modmul_launch", x, y, q32, qneg)


def modadd_cuda(x, y, q32):
    return _launch("modadd", "modadd_launch", x, y, q32)
