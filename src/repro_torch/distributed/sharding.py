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

The reference's ``ShardingRules.sharding`` / ``constrain`` and its
module-level ``shard`` are GSPMD constraints that only the LM's tensor
parallelism reads; they come with the LM half of the multi-device
schedule, not with the HE schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
