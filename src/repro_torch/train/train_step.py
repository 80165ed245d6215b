"""The train step: value and grad of the model loss, gradient accumulation
over microbatches, the optimizer update — counterpart of
``repro/train/train_step.py``.

Grads come from ``torch.autograd.grad`` on detached aliases of the
parameters that require grad (``torch.func.grad`` does not compose with
``torch.utils.checkpoint``).  Microbatch grads are summed in float32, as
the reference's ``lax.scan`` carry is.  The state is updated in place
(``train/optimizer.py``).

On a mesh (the current rules of ``distributed/sharding.py``) the state
holds a rank's blocks (``param_shardings``: the reference's path rules,
leaf by leaf, the optimizer's moments and error feedback included) and
the batch a rank's rows.  ``fsdp -> data`` is ZeRO-3: a block's leaves
split over ``data`` are gathered before use and their gradients
reduce-scattered (``sharding.gather_params``); every other leaf's
gradient is summed over the batch axes after the backward.  Tensor and
expert parallelism need no gradient sync of their own (the layers'
``copy_to`` / ``reduce_from`` pairs leave every leaf's gradient whole on
its model rank).  With microbatches on several data ranks, the ranks
first gather the (small) batch and each takes its share of every
microbatch, so a microbatch holds the one-device microbatch's rows (the
MoE's dispatch groups and aux loss depend on them).
``make_sharded_train_step`` checks the state and batch against the mesh
and returns the step.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.train.optimizer import OptConfig, apply_updates, init_opt_state
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's, without ``rs_accumulate``: both of its branches
    are the same float32 sum."""
    microbatches: int = 1
    opt: OptConfig = OptConfig()


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     gen: torch.Generator) -> dict:
    """{"params", "opt"}: ``tf.init_params`` on ``gen``'s device and its
    optimizer state (under a mesh, a rank's blocks of both)."""
    params = tf.init_params(cfg, gen)
    return {"params": params, "opt": init_opt_state(tcfg.opt, params)}


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """The train state's shapes and dtypes as ``meta`` tensors (nothing
    allocated): a template for ``checkpoint.restore``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = tf._init_whole(cfg, torch.Generator())
        state = {"params": params, "opt": init_opt_state(tcfg.opt, params)}
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """Microbatch i holds rows [i·B/n, (i+1)·B/n) of every leaf."""
    return [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n)]


def value_and_grad(cfg: ModelConfig, params, batch):
    """((total, metrics), grads) of ``tf.train_loss``: ``jax.value_and_grad(
    ..., has_aux=True)``'s result, detached; grads a list in
    ``tree.leaves(params)`` order, each in its parameter's dtype (zeros
    where the loss does not reach the parameter)."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    total, metrics = tf.train_loss(cfg, unflatten(params, live), batch)
    grads = torch.autograd.grad(total, live, allow_unused=True,
                                materialize_grads=True)
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            list(grads))


def train_step(cfg: ModelConfig, tcfg: TrainConfig, state: dict, batch: dict):
    """One optimizer step on ``batch`` (leaves of leading size the global
    batch).  Returns (state, metrics): the train loss's metrics with one
    microbatch, else {"loss"} (the mean total), and the optimizer's."""
    params = state["params"]
    nmb = tcfg.microbatches
    R = sh.ranks()
    if R is not None:
        return _train_step_mesh(cfg, tcfg, state, batch, R)
    if nmb == 1:
        (_, metrics), grads = value_and_grad(cfg, params, batch)
    else:
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves(params)]
        lsum = 0.0
        for mb in _split_microbatches(batch, nmb):
            (total, _), g = value_and_grad(cfg, params, mb)
            for acc, gi in zip(grads, g, strict=True):
                acc += gi
            lsum = lsum + total
        for acc in grads:
            acc /= nmb
        metrics = {"loss": lsum / nmb}
    params, opt, opt_metrics = apply_updates(
        tcfg.opt, params, unflatten(params, grads), state["opt"])
    return {"params": params, "opt": opt}, dict(metrics, **opt_metrics)


def _microbatch_major(batch: dict, nmb: int, R) -> dict:
    """The rank's rows when every microbatch is split over the batch axes:
    the ranks' rows gathered, then this rank's share of each microbatch,
    so microbatch i holds the one-device microbatch i's rows."""
    out = {}
    for k, v in batch.items():
        whole = coll.gather_cat(v, R.batch_group, R.D, 0)
        per = whole.shape[0] // (nmb * R.D)
        out[k] = whole.reshape((nmb, R.D, per) + tuple(whole.shape[1:]))[
            :, R.d].reshape((nmb * per,) + tuple(whole.shape[1:]))
    return out


def _sync_grads(grads: list, placements: list, R) -> list:
    """Each gradient in float32, summed over the batch axes it was not
    reduce-scattered over (ZeRO leaves were, over ``fsdp``)."""
    if R.D == 1:
        return grads
    rules = sh.get_rules()
    mesh = R.mesh
    batch = tuple(a for a in (rules.rules.get("batch") or ())
                  if a in mesh.shape)
    out = []
    for g, pl in zip(grads, placements, strict=True):
        g = g.float()
        used = {a for ax in pl.spec for a in
                ((ax,) if isinstance(ax, str) else tuple(ax or ()))}
        rest = tuple(a for a in batch if a not in used)
        if mesh.size(rest) > 1:
            coll.all_reduce_sum(g, mesh.group(rest))
        out.append(g)
    return out


def _train_step_mesh(cfg: ModelConfig, tcfg: TrainConfig, state: dict,
                     batch: dict, R):
    params = state["params"]
    nmb = tcfg.microbatches
    pl = leaves(tf._placements(cfg))
    split = R.D > 1
    with sh.batch_split(split):
        if nmb == 1:
            (_, metrics), grads = value_and_grad(cfg, params, batch)
        else:
            if split:
                batch = _microbatch_major(batch, nmb, R)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            lsum = 0.0
            for mb in _split_microbatches(batch, nmb):
                (total, _), g = value_and_grad(cfg, params, mb)
                for acc, gi in zip(grads, g, strict=True):
                    acc += gi
                lsum = lsum + total
            for acc in grads:
                acc /= nmb
            loss = lsum / nmb
            if split:
                loss = coll.all_reduce_sum(loss.reshape(1),
                                           R.batch_group)[0]
            metrics = {"loss": loss}
    grads = _sync_grads(grads, pl, R)
    params, opt, opt_metrics = apply_updates(
        tcfg.opt, params, unflatten(params, grads), state["opt"],
        placements=tf._placements(cfg))
    return {"params": params, "opt": opt}, dict(metrics, **opt_metrics)


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                            state_shapes, batch_shapes):
    """The train step on ``mesh`` (the current rules' mesh): checks that
    the state ``state_shapes`` holds a rank's blocks of
    ``param_shardings`` and that the batch leaves ``batch_shapes`` hold
    the rank's rows of a global batch the batch axes divide, and returns
    ``step(state, batch) -> (state, metrics)`` (the state updated in
    place, the metrics the global batch's)."""
    rules = sh.get_rules()
    if rules.mesh is not mesh:
        raise ValueError("install the mesh's rules first: "
                         "sharding.set_rules(sharding.make_rules(mesh))")
    whole = abstract_train_state(cfg, tcfg)
    want = param_shardings(cfg, whole, rules)
    for (path, t), (_, w), (_, q) in zip(leaves_with_paths(state_shapes),
                                         leaves_with_paths(whole),
                                         leaves_with_paths(want),
                                         strict=True):
        if tuple(t.shape) != q.local_shape(w.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: {tuple(t.shape)}"
                             f" on this rank, its placement gives "
                             f"{q.local_shape(w.shape)}")
    R = sh.ranks(rules)
    for k, t in batch_shapes.items():
        if (t.shape[0] * R.D) % (R.D * tcfg.microbatches):
            raise ValueError(f"batch leaf {k}: {t.shape[0]} rows a rank do "
                             f"not split into {tcfg.microbatches} "
                             f"microbatches")
    return functools.partial(train_step, cfg, tcfg)


# logical axes per parameter leaf name, for the TRAILING dims (a leading
# 'layers' axis of the reference's stacked leaves is handled separately).
# TP over ff/heads/experts/vocab, ZeRO/FSDP over the d_model-ish dim.
_LEAF_AXES = {
    "embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "kv_heads"),
    "wv": ("fsdp", "kv_heads"),
    "wo2": ("ff", "fsdp"),                # dense wo (f, d)
    "wo3": ("experts", "ff", "fsdp"),     # MoE wo (E, f, d)
    "wi_up2": ("fsdp", "ff"),
    "wi_gate2": ("fsdp", "ff"),
    "wi_up3": ("experts", "fsdp", "ff"),
    "wi_gate3": ("experts", "fsdp", "ff"),
    "router": ("fsdp", "experts"),
    "in_proj": ("fsdp", "ff"),
    "out_proj": ("ff", "fsdp"),
    "kx": ("fsdp", "kv_heads"),
    "vx": ("fsdp", "kv_heads"),
    "conv_w": (None, "ff"),
}

#: leaves whose last dimension packs segments (``models/ssm.py``)
_PACKED = ("in_proj", "conv_w")


def _leaf_logical_axes(name: str, nd: int) -> tuple:
    axes = _LEAF_AXES.get(f"{name}{nd}") or _LEAF_AXES.get(name)
    if axes is None or len(axes) != nd:
        axes = (None,) * nd
    return tuple(axes)


#: logical axes that map to ``model`` in a block that runs whole there
_MODEL_AXES = ("heads", "kv_heads", "ff")


def _whole_on_model(cfg: ModelConfig, path: tuple, rules) -> bool:
    """Whether the leaf at ``path`` belongs to a sub-layer that runs whole
    on every model rank: attention (self or cross) whose heads do not
    split the model axis, an SSM layer whose heads do not."""
    from repro_torch.distributed.sharding import logical_axis_size
    from repro_torch.models.common import attn_replicated
    from repro_torch.models.ssm import ssm_replicated
    M = logical_axis_size(rules, "heads")
    if "attn" in path or "cross" in path or path[-1] in ("kx", "vx"):
        return attn_replicated(cfg, M)
    return "ssm" in path and ssm_replicated(cfg, M)


def leaf_placement(cfg: ModelConfig, path: tuple, shape, rules):
    """The :class:`~repro_torch.distributed.sharding.Placement` of one
    leaf of the port's tree: the reference's rule for its name and rank
    (a block's leaf is the reference's stacked leaf without its leading
    ``layers`` axis, which is replicated), axes that do not divide
    dropped; a packed SSM leaf split over ``model`` by its segments.  A
    leaf of a sub-layer whose heads do not split the model axis is whole
    over ``model`` (``_whole_on_model``; the reference keeps such a
    weight's even column split, a layout its compiler gathers)."""
    from repro_torch.distributed.sharding import sanitize_spec
    from repro_torch.models.ssm import packed_segments
    name = str(path[-1]) if path else ""
    axes = _leaf_logical_axes(name, len(shape))
    if _whole_on_model(cfg, path, rules):
        axes = tuple(None if ax in _MODEL_AXES else ax for ax in axes)
    logical = sanitize_spec(rules, axes, shape)
    spec = rules.spec(*logical)
    segments = None
    if name in _PACKED and spec and spec[-1] is not None:
        segments = (len(shape) - 1, packed_segments(cfg, name))
    return rules.sharding(*logical, segments=segments)


def param_shardings(cfg: ModelConfig, state_shapes, rules):
    """Every leaf of a (train state or parameter) tree of whole shapes ->
    its Placement, by the reference's path rules (``leaf_placement``);
    None leaves without a mesh.  Shardings that do not divide a dimension
    evenly are dropped (replicated), so every config runs on every
    mesh."""
    if rules.mesh is None:
        return tree_map(lambda _: None, state_shapes)
    flat = [leaf_placement(cfg, path, tuple(t.shape), rules)
            for path, t in leaves_with_paths(state_shapes)]
    return unflatten(state_shapes, flat)
