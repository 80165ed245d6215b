"""Logical-axis sharding rules — counterpart of
``repro/distributed/sharding.py``.

Code names the axes of its arrays with *logical* names; a
:class:`ShardingRules` table maps each to physical mesh axes.  The
production mesh is (pod, data, model): data parallel over pod × data,
tensor / expert parallel over model.  The HE schedule reads two rules:
``limbs -> model`` (RNS limbs of the extended basis, ``core/hlt_dist.py``)
and ``ct_batch -> (pod, data)`` (independent ciphertexts).

A mesh here is duck-typed on its axis names and their sizes: any object
with ``axis_names`` (a tuple) and ``shape`` (a mapping axis -> size), such
as ``launch/mesh.py`` :class:`~repro_torch.launch.mesh.Mesh`.  ``spec``
returns a tuple of physical axis names (or tuples of them, or None) per
dimension, the reference's ``PartitionSpec`` entries.

The LM's layers run on explicit local shards (Megatron-style column- and
row-parallel products, ``distributed/collectives.py``), not under a
compiler that places arrays: ``ShardingRules.sharding`` returns a
:class:`Placement` (the port's ``NamedSharding``: the mesh and the spec)
that cuts a rank's block out of a whole tensor (``local``) and puts the
whole back together from the ranks' blocks (``gather``).  ``constrain`` /
``shard`` do what the reference's do to the spec (axes that do not divide
their dimension are dropped) and, under a mesh, check that a layer's
local tensor has the shape that spec gives it; they issue no collective.

A rank's block is the contiguous one GSPMD would hold, except along a
*packed* dimension (``Placement.segments``): the Mamba2 ``in_proj``
output (z | x | B | C | dt), the ``conv_w`` columns and the serve cache's
``conv`` channels (x | B | C).  The reference shards such a dimension
evenly, which is only a layout under GSPMD and does not line up with the
segments; here a rank holds its heads' part of each head-split segment
(z, x, dt) and the whole of each replicated one (B and C, one group), so
its products stay local.  ``local`` and ``gather`` still round-trip the
whole leaf.

One dimension may also split *unevenly* (``Placement.ceil``): the serve
cache's sequence, when the KV heads do not split the model axis and the
model axis does not divide the cache's length.  The reference drops such
an axis (the whole cache on every rank); here a rank holds a block of
⌈L / n⌉ positions, the last rank's tail past L padding that is never
written, so a rank keeps the memory the sequence split exists for.
``gather`` returns exactly the first L positions.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import collectives

#: default logical -> physical mapping; None = replicated
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),      # data parallel over pod+data
    "seq": None,                   # sequence replicated by default
    "seq_sp": ("model",),          # sequence-parallel variant (long context)
    "d_model": None,
    "heads": ("model",),           # TP: attention heads
    "kv_heads": ("model",),
    "head_dim": None,
    "ff": ("model",),              # TP: MLP hidden
    "experts": ("model",),         # EP: experts over model axis
    "expert_cap": None,
    "vocab": ("model",),           # TP: embedding/logits
    "layers": None,                # scan axis
    "fsdp": ("data",),             # ZeRO-3 style param shard over data
    # HE MM axes
    "limbs": ("model",),           # RNS limb-parallel (core/hlt_dist.py)
    "ct_batch": ("pod", "data"),   # independent ciphertexts / matrix blocks
    "coeff": None,
}


@dataclasses.dataclass
class ShardingRules:
    rules: dict
    mesh: Optional[object] = None

    def spec(self, *logical: Optional[str]) -> tuple:
        """Map logical axis names to physical ones, one entry a dimension:
        None (replicated), one axis name, or a tuple of them.  A physical
        axis is used once; axes the mesh lacks are dropped."""
        phys = []
        used: set = set()
        for name in logical:
            axes = None if name is None else self.rules.get(name)
            if axes is None:
                phys.append(None)
                continue
            avail = tuple(a for a in axes
                          if a not in used and self._axis_in_mesh(a))
            used.update(avail)
            if not avail:
                phys.append(None)
            elif len(avail) == 1:
                phys.append(avail[0])
            else:
                phys.append(avail)
        return tuple(phys)

    def _axis_in_mesh(self, axis: str) -> bool:
        return self.mesh is None or axis in self.mesh.axis_names

    def sharding(self, *logical, segments=None,
                 ceil=None) -> Optional["Placement"]:
        """The :class:`Placement` of ``logical`` on the mesh (None without
        a mesh).  ``segments``: a packed dimension's layout, ``ceil`` an
        uneven one (see :class:`Placement`)."""
        if self.mesh is None:
            return None
        return Placement(self.mesh, self.spec(*logical), segments, ceil)

    def constrain(self, x, *logical, full=None):
        """The reference's ``with_sharding_constraint``: a no-op without a
        mesh.  Axes that do not divide their dimension are dropped
        (replicated).  Under a mesh ``x`` is a rank's local block and
        ``full`` the whole tensor's shape (None for a dimension the caller
        leaves unchecked): a dimension whose axis survives must be
        ``full[i] / n`` long, any other ``full[i]``; a mismatch raises.
        Returns ``x``; no collective is issued."""
        if self.mesh is None:
            return x
        full = tuple(full) if full is not None else (None,) * x.ndim
        spec = sanitize_spec(self, logical,
                             [f if f is not None else 0 for f in full])
        phys = self.spec(*spec)
        for i, (ax, f) in enumerate(zip(phys, full)):
            if f is None:
                continue
            axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
            want = f // self.mesh.size(axes) if axes else f
            if x.shape[i] != want:
                raise ValueError(
                    f"shard{tuple(logical)}: dimension {i} is {x.shape[i]} "
                    f"on this rank, the spec {phys} of a {tuple(full)} "
                    f"tensor gives {want}")
        return x


@dataclasses.dataclass(frozen=True)
class Placement:
    """A tensor's layout on a mesh: ``spec`` gives each dimension's mesh
    axis (None, a name, or a tuple of names, the reference's
    ``PartitionSpec``), and a rank holds the block of its coordinates.
    ``segments``, when set, is ``(dim, ((size, split), ...))``: dimension
    ``dim`` packs segments of those sizes, and a rank holds its block of
    each ``split`` one and the whole of each other (module docstring).
    ``ceil``, when set, is ``(dim, length)``: dimension ``dim``, of
    ``length`` whole, splits in blocks of ⌈length / n⌉, the last ranks'
    positions past ``length`` zero padding."""
    mesh: object
    spec: tuple
    segments: Optional[tuple] = None
    ceil: Optional[tuple] = None

    def _axes(self, dim: int) -> tuple:
        ax = self.spec[dim]
        return (ax,) if isinstance(ax, str) else tuple(ax)

    def _uneven(self, dim: int) -> bool:
        return self.ceil is not None and self.ceil[0] == dim

    def local_shape(self, shape) -> tuple:
        out = list(shape)
        for dim, ax in enumerate(self.spec):
            if ax is None:
                continue
            n = self.mesh.size(self._axes(dim))
            if self.segments is not None and self.segments[0] == dim:
                out[dim] = sum(size // n if split else size
                               for size, split in self.segments[1])
            elif self._uneven(dim):
                out[dim] = -(-out[dim] // n)
            else:
                out[dim] //= n
        return tuple(out)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``full``."""
        t = full
        for dim, ax in enumerate(self.spec):
            if ax is None:
                continue
            axes = self._axes(dim)
            n, i = self.mesh.size(axes), self.mesh.index(axes)
            if self.segments is not None and self.segments[0] == dim:
                parts = t.split([size for size, _ in self.segments[1]], dim)
                t = torch.cat([p.chunk(n, dim)[i] if split else p
                               for p, (_, split) in zip(parts,
                                                        self.segments[1])],
                              dim=dim)
            elif self._uneven(dim):
                pad = list(t.shape)
                pad[dim] = -t.shape[dim] % n
                t = torch.cat([t, t.new_zeros(pad)], dim).chunk(n, dim)[i]
            else:
                if t.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of {tuple(full.shape)}"
                                     f" does not split {n} ways")
                t = t.chunk(n, dim)[i]
        return t.contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (an all-gather along
        each split dimension, through ``collectives``); every rank of the
        mesh calls it."""
        t = local
        for dim, ax in enumerate(self.spec):
            if ax is None:
                continue
            axes = self._axes(dim)
            n = self.mesh.size(axes)
            if n == 1:
                continue
            blocks = collectives.all_gather(t.contiguous(),
                                            self.mesh.group(axes), n)
            if self.segments is not None and self.segments[0] == dim:
                sizes = [size // n if split else size
                         for size, split in self.segments[1]]
                pieces = [b.split(sizes, dim) for b in blocks]
                t = torch.cat(
                    [torch.cat([p[j] for p in pieces], dim) if split
                     else pieces[0][j]
                     for j, (_, split) in enumerate(self.segments[1])],
                    dim=dim)
            else:
                t = torch.cat(blocks, dim=dim)
                if self._uneven(dim):
                    t = t.narrow(dim, 0, self.ceil[1])
        return t


def logical_axis_size(rules: ShardingRules, ax: Optional[str]) -> int:
    """Product of the mesh-axis sizes a logical axis maps to (1 if
    unmapped or without a mesh)."""
    if ax is None or rules.mesh is None:
        return 1
    phys = rules.rules.get(ax)
    if not phys:
        return 1
    total = 1
    for a in phys:
        if a in rules.mesh.shape:
            total *= rules.mesh.shape[a]
    return total


def sanitize_spec(rules: ShardingRules, axes, shape) -> tuple:
    """Drop logical axes that do not divide their dimension (replicate
    them)."""
    return tuple(ax if ax and dim % logical_axis_size(rules, ax) == 0 else None
                 for ax, dim in zip(axes, shape, strict=False))


def make_rules(mesh=None, overrides: Optional[dict] = None) -> ShardingRules:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return ShardingRules(rules=rules, mesh=mesh)


# A process-global "current rules" so model code stays uncluttered: a
# launcher installs mesh-bound rules; without one the no-mesh default holds.
_CURRENT = make_rules()


def set_rules(rules: ShardingRules) -> None:
    global _CURRENT
    _CURRENT = rules


def get_rules() -> ShardingRules:
    return _CURRENT


def shard(x, *logical, full=None):
    """``get_rules().constrain(x, *logical, full=full)``."""
    return _CURRENT.constrain(x, *logical, full=full)


# ---------------------------------------------------------------------------
# a rank's view, for the layers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ranks:
    """What a layer reads of the current rules' mesh: the ``model`` axis
    (size ``M``, this rank's index ``m``, its process group), the
    ``batch`` axes (pod × data: ``D``, ``d``, ``batch_group``) and the
    ``fsdp`` axis (``F``, ``f``, ``fsdp_group``)."""
    mesh: object
    M: int
    m: int
    model_group: object
    D: int
    d: int
    batch_group: object
    F: int
    f: int
    fsdp_group: object

    def split(self, n: int) -> bool:
        """Whether a dimension of ``n`` mapped to ``model`` is split (the
        reference drops an axis that does not divide)."""
        return self.M > 1 and n % self.M == 0

    def part(self, n: int) -> slice:
        """This model rank's block of a dimension of ``n`` split over
        ``model`` (all of it when it is not split)."""
        if not self.split(n):
            return slice(0, n)
        k = n // self.M
        return slice(self.m * k, (self.m + 1) * k)


def _logical_axes(rules: ShardingRules, logical: str) -> tuple:
    return tuple(a for a in (rules.rules.get(logical) or ())
                 if a in rules.mesh.shape)


def ranks(rules: Optional[ShardingRules] = None) -> Optional[Ranks]:
    """The current rules' :class:`Ranks`, or None without a mesh."""
    rules = _CURRENT if rules is None else rules
    mesh = rules.mesh
    if mesh is None:
        return None
    out = {}
    for key, logical in (("model", "heads"), ("batch", "batch"),
                         ("fsdp", "fsdp")):
        axes = _logical_axes(rules, logical)
        out[key] = (mesh.size(axes), mesh.index(axes),
                    mesh.group(axes) if axes else None)
    return Ranks(mesh, *out["model"], *out["batch"], *out["fsdp"])


_BATCH_SPLIT = [False]


@contextlib.contextmanager
def batch_split(split: bool = True):
    """Inside the block, the layers' activations hold this rank's rows of
    the batch (split over the ``batch`` axes: a train step, a decode step);
    outside, every rank holds the whole batch (a one-request prefill)."""
    _BATCH_SPLIT.append(split)
    try:
        yield
    finally:
        _BATCH_SPLIT.pop()


def is_batch_split() -> bool:
    return _BATCH_SPLIT[-1]


def gather_params(tree, placements):
    """ZeRO-3: every leaf of ``tree`` (a rank's blocks) gathered along the
    dimensions its :class:`Placement` splits over the ``fsdp`` axes
    (forward all-gather, backward reduce-scatter); leaves split over
    ``model`` only are returned as they are.  ``placements`` is the
    matching tree of placements (None: no mesh, ``tree`` itself)."""
    if placements is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_params(v, placements[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gather_params(v, p) for v, p in zip(tree, placements)]
    if placements is None or not isinstance(tree, torch.Tensor):
        return tree
    rules = _CURRENT
    fsdp = _logical_axes(rules, "fsdp")
    t = tree
    for dim, ax in enumerate(placements.spec):
        axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
        if axes and set(axes) <= set(fsdp):
            mesh = placements.mesh
            t = collectives.gather_fsdp(t, mesh.group(axes), mesh.size(axes),
                                        mesh.index(axes), dim)
    return t
