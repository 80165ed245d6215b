"""The collectives of the multi-device schedules: the one place the port
calls ``torch.distributed`` on its data.

The HE schedule: ``all_reduce_sum`` is the sharded HLT's merged
ModDown+Rescale BaseConv reduction (``core/hlt_dist.py``), the schedule's
sole collective; ``all_gather`` assembles a sharded HLT's output blocks
after its body.

The LM's tensor, expert and data parallelism (Megatron-style local
shards, ``distributed/sharding.py``) adds ``all_reduce_max``,
``reduce_scatter`` (an all-reduce of which a rank keeps its block: gloo,
which ranks that share one card need, is the lowest common backend),
``barrier``, ``gather_cat``, and the autograd pairs the layers are built
from (16-bit floats cross as float32):

* :func:`copy_to` — forward identity, backward all-reduce (into a
  column-parallel layer: a replicated activation whose ranks' gradients
  are partial);
* :func:`reduce_from` — forward all-reduce, backward identity (out of a
  row-parallel layer);
* :func:`sum_over` — forward and backward all-reduce (a partial sum that
  split layers read again, the SSM's norm over its heads);
* :func:`gather_from` — forward all-gather along a dimension, backward a
  rank's block (logits over the vocabulary, a weight gathered for a
  replicated product);
* :func:`scatter_to` — forward a rank's block, backward all-gather (a
  replicated weight read by a split layer);
* :func:`gather_fsdp` — forward all-gather, backward reduce-scatter
  (ZeRO-3: a weight split over ``data`` gathered before use).

Each call adds one to ``COUNTS`` and its bytes to ``BYTES`` (an
all-reduce or reduce-scatter: the tensor it contributes; an all-gather:
the tensor it assembles), and its (kind, bytes, the group's ranks) to
every :func:`scope` open around it: the verifier's collective census
(``analysis/census.py``, rule JX001) and the cost reports
(``distributed/hlo_cost.py``, ``hlo_analysis.collective_stats``) read a
scope.  A collective over a group of one rank (``group`` None) is not
issued and not counted.

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
COUNTS = {"all_reduce": 0, "all_gather": 0, "all_reduce_max": 0,
          "reduce_scatter": 0, "barrier": 0}
BYTES = {k: 0 for k in COUNTS}

_SCOPES: list = []


def reset() -> None:
    for d in (COUNTS, BYTES):
        for k in d:
            d[k] = 0


@contextlib.contextmanager
def scope(events=None):
    """Inside the ``with`` block, every collective's (kind, bytes, the
    group's ranks) is appended to ``events`` (anything with ``append``;
    a new list when None), which the block gets."""
    events = [] if events is None else events
    _SCOPES.append(events)
    try:
        yield events
    finally:
        _SCOPES[:] = [e for e in _SCOPES if e is not events]


def _record(kind: str, nbytes: int, group=None) -> None:
    COUNTS[kind] += 1
    BYTES[kind] += nbytes
    if _SCOPES:
        event = (kind, nbytes, dist.get_world_size(group))
        for events in _SCOPES:
            events.append(event)


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
    _record("all_reduce", t.numel() * t.element_size(), group)
    with _sync_check_suspended():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, size: int) -> list:
    """The ``size`` ranks' tensors of ``t``'s shape, in group rank order."""
    out = [torch.empty_like(t) for _ in range(size)]
    _record("all_gather", size * t.numel() * t.element_size(), group)
    with _sync_check_suspended():
        dist.all_gather(out, t.contiguous(), group=group)
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks of ``group``, in
    place; returns ``t``."""
    _record("all_reduce_max", t.numel() * t.element_size(), group)
    with _sync_check_suspended():
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def reduce_scatter(t: torch.Tensor, group, size: int, index: int,
                   dim: int = 0) -> torch.Tensor:
    """Rank ``index``'s block (of ``size`` along ``dim``) of the sum of
    ``t`` over ``group``: an all-reduce of which a rank keeps its block."""
    dtype = t.dtype
    t = t.float() if dtype in _NARROW else t.contiguous().clone()
    _record("reduce_scatter", t.numel() * t.element_size(), group)
    with _sync_check_suspended():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.chunk(size, dim)[index].to(dtype).contiguous()


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the whole world when None)."""
    _record("barrier", 0, group)
    with _sync_check_suspended():
        dist.barrier(group=group)


_NARROW = (torch.bfloat16, torch.float16)


def gather_cat(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``t`` concatenated along ``dim``, in group rank
    order; ``t`` itself when the group holds one rank.  16-bit floats
    travel as float32 (exactly), which every backend carries."""
    if group is None or size == 1:
        return t
    if t.dtype in _NARROW:
        return gather_cat(t.float(), group, size, dim).to(t.dtype)
    return torch.cat(all_gather(t, group, size), dim=dim)


# ---------------------------------------------------------------------------
# autograd pairs (group None: one rank, the identity both ways)
# ---------------------------------------------------------------------------


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor, the sum of ``t`` over ``group``; 16-bit floats are
    summed in float32 (each rank's partial rounded once, as a product's
    output on one device), then rounded back."""
    if t.dtype in _NARROW:
        return all_reduce_sum(t.float(), group).to(t.dtype)
    return all_reduce_sum(t.contiguous().clone(), group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.size, ctx.index, ctx.dim = size, index, dim
        return gather_cat(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.size, ctx.dim)[ctx.index].contiguous(), None,
                None, None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return x.chunk(size, dim)[index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g, ctx.group, ctx.size, ctx.dim), None, None, \
            None, None


class _GatherFsdp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.group, ctx.size, ctx.index, ctx.dim = group, size, index, dim
        return gather_cat(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.group, ctx.size, ctx.index, ctx.dim),
                None, None, None, None)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumOver.apply(x, group)


def gather_from(x: torch.Tensor, group, size: int, index: int,
                dim: int) -> torch.Tensor:
    if group is None or size == 1:
        return x
    return _GatherFrom.apply(x, group, size, index, dim)


def scatter_to(x: torch.Tensor, group, size: int, index: int,
               dim: int) -> torch.Tensor:
    if size == 1:
        return x
    return _ScatterTo.apply(x, group, size, index, dim)


def gather_fsdp(x: torch.Tensor, group, size: int, index: int,
                dim: int) -> torch.Tensor:
    if group is None or size == 1:
        return x
    return _GatherFsdp.apply(x, group, size, index, dim)
