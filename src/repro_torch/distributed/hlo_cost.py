"""Loop-aware cost counter — counterpart of
``repro/distributed/hlo_cost.py``.

The reference parses XLA's optimized HLO and multiplies each
instruction's cost by the trip counts of the ``while`` loops around it.
The port has no HLO: it counts the torch operations a run dispatches,
one by one, in a ``TorchDispatchMode`` (:func:`count`), on real tensors
or on fake ones (``FakeTensorMode``: shapes only, nothing allocated):

  flops  — dot ops only: ``torch.utils.flop_counter``'s formulas
           (mm / bmm / addmm / baddbmm / convolution / SDPA: 2·|out|·K);
           einsums reach them through their decomposition;
  bytes  — every op that materializes a tensor: operands + output
           (the reference's rules, ``hbm_bytes``): a view costs nothing;
           an index / gather / index_select costs 2 × its output; an
           ``index_put_`` / scatter / ``copy_`` (an in-place slice
           write) 2 × the update;
  int_elem_ops — output *elements* of elementwise ops (not bytes / 4 as
           the reference counts u32 words: the port computes in int64);
  collective bytes — what ``distributed/collectives.py`` issued inside
           the window, the bytes a rank sends
           (``hlo_analysis.link_bytes``), by the reference's op names.

Unlike HLO, nothing is fused: each op's operands and output count, so
the bytes are those of the eager program, an upper bound on a fused
one's.

Trip counts: a loop of shape-identical bodies is counted once and
multiplied by its trip count, the reference's rule, inside
``counter.repeat(n, name)`` (``trip_counts[name] = n``); :func:`loop`
runs the body once under that scope when a counter is active over fake
tensors (``FakeTensorMode``: no value is computed) and no gradient is
recorded, else all n times, so a run on real tensors keeps its values.  The SSD recurrence of
``models/ssm.py``, which the reference runs as a ``lax.scan``, goes
through it (counted step by step a 32k-token prefill would dispatch
every op 32,768 times a layer), and so do the SSD's chunk loop and the
KV-block loop of ``models/common.py``'s blockwise attention.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch._guards import detect_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import collectives
from repro_torch.distributed.hlo_analysis import COLLECTIVE_OPS, link_bytes

_ATEN = torch.ops.aten
#: ops that read only what they write: 2 × the output
_SLICE_LIKE = {_ATEN.index.Tensor, _ATEN.index_select.default,
               _ATEN.gather.default, _ATEN.narrow_copy.default,
               _ATEN.slice_copy.Tensor, _ATEN.select_copy.int,
               _ATEN.embedding.default}
#: in-place writes of an update (the update's argument index): 2 × it
_UPDATES = {_ATEN.index_put_.default: 2, _ATEN.index_put.default: 2,
            _ATEN._index_put_impl_.default: 2,
            _ATEN.scatter.src: 3, _ATEN.scatter_.src: 3,
            _ATEN.scatter_add.default: 3, _ATEN.scatter_add_.default: 3,
            _ATEN.index_add.default: 3, _ATEN.index_add_.default: 3,
            _ATEN.slice_scatter.default: 1, _ATEN.select_scatter.default: 1,
            _ATEN.copy_.default: 1}
#: views whose schema declares no alias (a matmul's reshape)
_VIEWS = {_ATEN._unsafe_view.default}
#: pointwise-tagged ops that compute nothing
_COPIES = {_ATEN.clone.default}
#: allocations that write nothing
_EMPTY = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
          _ATEN.empty_like.default, _ATEN.new_empty.default,
          _ATEN.new_empty_strided.default}


@dataclasses.dataclass
class HloCost:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    collectives_by_op: dict
    trip_counts: dict
    int_elem_ops: float = 0.0     # elementwise output elements


def _nbytes(t) -> int:
    """The bytes of the distinct elements ``t`` holds: a broadcast
    (stride 0) dimension counts once."""
    if not isinstance(t, torch.Tensor):
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _alias(func):
    """The alias info of ``func``'s first output (None for a fresh
    tensor; a view's does not write, an in-place op's does)."""
    rets = func._schema.returns
    return rets[0].alias_info if rets else None


def _is_view(func) -> bool:
    info = _alias(func)
    return func in _VIEWS or (info is not None and not info.is_write)


def hbm_bytes(func, args, kwargs, out) -> int:
    """The bytes one op moves (module docstring)."""
    outs = _tensors(out)
    if func in _EMPTY or not outs:
        return 0                        # nothing written
    if func in _UPDATES:
        i = _UPDATES[func]
        upd = args[i] if len(args) > i else None
        return 2 * (_nbytes(upd) or sum(map(_nbytes, outs)))
    if func in _SLICE_LIKE:
        return 2 * sum(map(_nbytes, outs))
    if _is_view(func):
        return 0
    return sum(map(_nbytes, _tensors((args, kwargs)))) + sum(map(_nbytes, outs))


_ACTIVE: list = []


class Counter(TorchDispatchMode):
    """A counted window (:func:`count`); ``cost()`` returns its
    :class:`HloCost`, ``peak_bytes`` the most bytes the window's own
    tensors held at once (they are tracked until freed)."""

    def __init__(self):
        super().__init__()
        self._mult = 1
        self.flops = 0.0
        self.bytes = 0.0
        self.elems = 0.0
        self.coll: dict = defaultdict(float)
        self.trips: dict = {}
        self.live = 0
        self.peak_bytes = 0

    @contextlib.contextmanager
    def repeat(self, n: int, name: str = "loop"):
        """Counts inside the block count ``n`` times: run one body of a
        loop of ``n`` shape-identical ones in it."""
        n = max(1, int(n))
        self.trips[name] = n
        self._mult *= n
        try:
            yield
        finally:
            self._mult //= n

    def append(self, event: tuple) -> None:
        """A collective's (kind, bytes, ranks), from the
        ``collectives.scope`` the window opens."""
        kind, nbytes, ranks = event
        op = COLLECTIVE_OPS.get(kind)
        if op is not None:
            self.coll[op] += link_bytes(kind, nbytes, ranks) * self._mult

    def _freed(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("c10d", "_c10d_functional"):
            return out              # counted by the collectives' scope
        m = self._mult
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out) * m
        self.bytes += hbm_bytes(func, args, kwargs, out) * m
        if torch.Tag.pointwise in func.tags and func not in _COPIES:
            self.elems += sum(t.numel() for t in _tensors(out)) * m
        if _alias(func) is None and func not in _VIEWS:   # fresh tensors
            for t in _tensors(out):
                nb = _nbytes(t)
                self.live += nb
                weakref.finalize(t, self._freed, nb)
            self.peak_bytes = max(self.peak_bytes, self.live)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        self._scope = collectives.scope(self)
        self._scope.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._scope.__exit__(*exc)
            _ACTIVE.remove(self)

    def cost(self) -> HloCost:
        return HloCost(flops=self.flops, bytes_accessed=self.bytes,
                       collective_bytes=float(sum(self.coll.values())),
                       collectives_by_op=dict(self.coll),
                       trip_counts=dict(self.trips), int_elem_ops=self.elems)


def count() -> Counter:
    """``with count() as c: ...`` counts the block; ``c.cost()``."""
    return Counter()


def loop(n: int, name: str):
    """``range(n)`` for a loop of shape-identical bodies; under a
    counter (:func:`count`) in a ``FakeTensorMode``, one body counted
    ``n`` times (``Counter.repeat``), unless autograd records the body
    (its backward would run outside the scope).  A caller that stacks
    the bodies' results stacks them with :func:`stack`."""
    c = _ACTIVE[-1] if _ACTIVE else None
    if (c is None or n <= 1 or torch.is_grad_enabled()
            or detect_fake_mode() is None):
        yield from range(n)
        return
    with c.repeat(n, name):
        yield 0


def stack(results: list, n: int, dim: int) -> torch.Tensor:
    """``torch.stack(results, dim)`` of a :func:`loop` of ``n`` bodies: a
    folded loop's one result expanded to ``n`` and made contiguous, which
    moves the bytes the stack of ``n`` would."""
    out = torch.stack(results, dim=dim)
    if len(results) == n:
        return out
    shape = list(out.shape)
    shape[dim] = n
    return out.expand(shape).contiguous()
