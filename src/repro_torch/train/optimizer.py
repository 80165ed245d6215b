"""AdamW with mixed precision (params in their own dtype, float32 master
weights and moments), global-norm clipping, cosine LR, and optional int8
gradient compression with error feedback — counterpart of
``repro/train/optimizer.py``.

The state is the reference's, key for key, and is the checkpoint's
format: ``step`` (int32, 0-d), float32 ``master``, ``m``, ``v`` and, with
``compress_grads``, ``ef``, each a tree shaped like the parameters.
``apply_updates`` runs the reference's operations in its order, leaf by
leaf, and writes the result into the state's and the parameters' own
tensors: the reference's launcher jits its step with the state donated
(``donate_argnums=(0,)``), so no second copy of the float32 master, m
and v (22.7 GB at ``internlm2-1.8b``) is made here either.

On a mesh (``placements`` given) a leaf is a rank's block: the global
gradient norm sums each block's squares over the axes its placement
splits (a replicated leaf, or the replicated segments of a packed one,
counted once), and the int8 scale of a reference leaf is the maximum
over those axes (``collectives.all_reduce_max``), so both are the
one-device numbers.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.tree import (leaves, leaves_with_paths, reference_path,
                              tree_map)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False     # int8 + error feedback


def lr_at(cfg: OptConfig, step):
    """Linear warm-up, then a cosine to 0 at ``total_steps``.  ``step``: a
    Python int (a float back) or a 0-d integer tensor (a 0-d float32
    tensor on its device, as the reference computes an int32 step)."""
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    if not isinstance(step, torch.Tensor):
        t = min(max((step - cfg.warmup_steps) / span, 0.0), 1.0)
        cos = cfg.lr * 0.5 * (1.0 + math.cos(math.pi * t))
        return warm if step < cfg.warmup_steps else cos
    t = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
    cos = cfg.lr * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(cfg: OptConfig, params) -> dict:
    """Step 0; ``master`` a float32 copy of ``params``, ``m``, ``v`` (and
    ``ef``) float32 zeros, on the parameters' devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "master": tree_map(
                 lambda p: p.to(torch.float32, copy=True), params),
             "m": tree_map(zeros, params),
             "v": tree_map(zeros, params)}
    if cfg.compress_grads:
        state["ef"] = tree_map(zeros, params)
    return state


def _split_axes(pl) -> tuple:
    """The mesh axes a placement splits (none for None)."""
    if pl is None:
        return ()
    return tuple(a for ax in pl.spec for a in
                 ((ax,) if isinstance(ax, str) else tuple(ax or ())))


def _compress_decompress(gs: list, efs: list, pl=None) -> list:
    """int8 quantize (absmax) + error feedback residual, [(dequantized
    gradient, new residual)], over the blocks of one reference tensor:
    ``gs`` / ``efs`` are one leaf's gradient and residual, or a stacked
    leaf's, block by block, which share the reference's one scale; ``pl``
    the blocks' placement on a mesh (the maximum is taken over its split
    axes)."""
    gts = [g + ef for g, ef in zip(gs, efs, strict=True)]
    absmax = torch.stack([torch.max(torch.abs(gt)) for gt in gts]).max()
    axes = _split_axes(pl)
    if axes and pl.mesh.size(axes) > 1:
        absmax = coll.all_reduce_max(absmax.reshape(1),
                                     pl.mesh.group(axes))[0]
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    out = []
    for gt in gts:
        q = torch.clamp(torch.round(gt / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        out.append((deq, gt - deq))
    return out


def _global_norm(gs: list, pls: list) -> torch.Tensor:
    """√Σ g² over the whole tree from a rank's blocks: the squares summed
    locally by the axes a block is split over (a packed leaf's replicated
    segments apart), one all-reduce an axis set."""
    buckets: dict = {}
    for g, pl in zip(gs, pls, strict=True):
        axes = _split_axes(pl)
        parts = [(axes, g)]
        if pl is not None and pl.segments is not None and axes:
            dim, segs = pl.segments
            seg_axes = _split_axes_of_dim(pl, dim)
            n = pl.mesh.size(seg_axes)
            sizes = [size // n if split else size for size, split in segs]
            rep = tuple(a for a in axes if a not in seg_axes)
            parts = [(axes if split else rep, t) for t, (_, split) in
                     zip(g.split(sizes, dim), segs)]
        for key, t in parts:
            sq = torch.sum(torch.square(t))
            buckets[key] = buckets[key] + sq if key in buckets else sq
    total = 0.0
    for key in sorted(buckets):
        sq = buckets[key]
        if key and pls and _mesh_of(pls).size(key) > 1:
            mesh = _mesh_of(pls)
            sq = coll.all_reduce_sum(sq.reshape(1), mesh.group(key))[0]
        total = total + sq
    return torch.sqrt(total)


def _split_axes_of_dim(pl, dim: int) -> tuple:
    ax = pl.spec[dim]
    return (ax,) if isinstance(ax, str) else tuple(ax or ())


def _mesh_of(pls: list):
    return next(pl.mesh for pl in pls if pl is not None)


def apply_updates(cfg: OptConfig, params, grads, state, placements=None):
    """One AdamW step from ``grads`` (a tree like ``params``, any float
    dtype).  The float32 gradients are compressed first (with
    ``compress_grads``: one int8 scale a reference tensor, so the blocks
    of a stacked leaf share one), then clipped to ``clip_norm`` by their
    global norm; the bias-corrected update with decoupled weight decay moves
    ``master``, and each parameter becomes its master cast to its own
    dtype.  ``params`` and ``state`` are updated in place (module
    docstring) and returned, with ``{"grad_norm", "lr"}`` (0-d tensors;
    the norm is the compressed gradients', before clipping).
    ``placements``: the parameters' placements on a mesh (module
    docstring), None on one device."""
    gs = [g.to(torch.float32) for g in leaves(grads)]
    pls = (leaves(placements) if placements is not None
           else [None] * len(gs))
    if cfg.compress_grads:
        tensors = {}        # the reference's leaf -> indices of its blocks
        for i, (path, _) in enumerate(leaves_with_paths(grads)):
            tensors.setdefault(reference_path(path)[0], []).append(i)
        efs = leaves(state["ef"])
        for idx in tensors.values():
            pairs = _compress_decompress([gs[i] for i in idx],
                                         [efs[i] for i in idx], pls[idx[0]])
            for i, (deq, residual) in zip(idx, pairs):
                gs[i] = deq
                efs[i].copy_(residual)
    if placements is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in gs))
    else:
        gnorm = _global_norm(gs, pls)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)

    step = state["step"]
    step += 1
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    for p, master, g, m, v in zip(leaves(params), leaves(state["master"]),
                                  gs, leaves(state["m"]), leaves(state["v"]),
                                  strict=True):
        g = g * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mh = m / b1c
        vh = v / b2c
        master.copy_(master - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                    + cfg.weight_decay * master))
        p.copy_(master)
    return params, state, {"grad_norm": gnorm, "lr": lr}
