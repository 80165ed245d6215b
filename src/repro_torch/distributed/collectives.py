"""The collectives of the multi-device HE schedule: the one place the port
calls ``torch.distributed`` on its data.

``all_reduce_sum`` is the sharded HLT's merged ModDown+Rescale BaseConv
reduction (``core/hlt_dist.py``), the schedule's sole collective;
``all_gather`` assembles a sharded HLT's output blocks after its body.
Each call adds one to ``COUNTS`` and its bytes to ``BYTES`` (an
all-reduce: the tensor it contributes; an all-gather: the tensor it
assembles), and to every :func:`scope` open around it: the verifier's
collective census (``analysis/census.py``, rule JX001) reads a scope.

A collective of CUDA tensors under the gloo backend is staged through
host memory by gloo itself, so it waits for the device: a census that
runs the body under ``torch.cuda.set_sync_debug_mode("error")`` (JX003)
suspends that check for the duration of the collective, and only then.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

#: collectives issued so far, by kind, and their bytes
COUNTS = {"all_reduce": 0, "all_gather": 0}
BYTES = {"all_reduce": 0, "all_gather": 0}

_SCOPES: list = []


def reset() -> None:
    for d in (COUNTS, BYTES):
        for k in d:
            d[k] = 0


@contextlib.contextmanager
def scope():
    """A dict that counts, by kind, the collectives issued inside the
    ``with`` block."""
    counts: dict = {}
    _SCOPES.append(counts)
    try:
        yield counts
    finally:
        _SCOPES.remove(counts)


def _record(kind: str, nbytes: int) -> None:
    COUNTS[kind] += 1
    BYTES[kind] += nbytes
    for counts in _SCOPES:
        counts[kind] = counts.get(kind, 0) + 1


@contextlib.contextmanager
def _sync_check_suspended():
    mode = (torch.cuda.get_sync_debug_mode() if torch.cuda.is_available()
            else 0)
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place; returns ``t``."""
    _record("all_reduce", t.numel() * t.element_size())
    with _sync_check_suspended():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, size: int) -> list:
    """The ``size`` ranks' tensors of ``t``'s shape, in group rank order."""
    out = [torch.empty_like(t) for _ in range(size)]
    _record("all_gather", size * t.numel() * t.element_size())
    with _sync_check_suspended():
        dist.all_gather(out, t.contiguous(), group=group)
    return out
