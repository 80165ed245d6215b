"""Mixture-of-Experts FFN — counterpart of ``repro/models/moe.py``:
token-choice top-k router, GShard-style grouped capacity dispatch.

Tokens are split into groups of ``GROUP``; each group computes its own
(g, E, C) dispatch / combine pair with C = ⌈g·k/E·cf⌉, so dispatch memory
scales linearly in tokens.  The router and the combine run in float32
whatever the activation dtype, as the reference's.  Ties among router
probabilities go to the lower expert index (``jax.lax.top_k``'s order),
and capacity positions count (token, k) pairs in the reference's
flattening, so the same tokens are dropped.

Under a mesh (expert parallelism): a rank holds E/M experts of ``wi_*`` /
``wo`` and the router's columns for them (``("fsdp", "experts")``).  Its
router logits are gathered over ``model`` before the top-k, so the
routing — top-k, the capacity positions (a cumsum over the group's
tokens) and the kept (token, expert) pairs — is computed whole on every
rank, as on one device; a rank then runs its experts over all tokens, and
the combine, a partial sum over experts, takes one all-reduce over
``model``.  When the experts do not divide the model axis the reference
splits ``ff`` instead (each expert column-/row-parallel, the same
all-reduce).  When the batch is split over ``data`` (pod × data) and a
rank's rows hold whole groups of the global batch's group size, the rank
routes and runs its own groups only, the reference's
``shard(xt, "batch", ...)``: the same tokens make the same groups, so
the routing, the capacity drops and the outputs are one device's.  The
aux loss stays the global batch's: the two (E,) means are summed over the
batch axes (``sum_over``: forward and backward all-reduce) before their
product.  When a group spans the ranks' rows (a decode step, where the
batch is one group), a rank gathers the tokens over the batch axes first
(backward: a reduce-scatter), routes every group and keeps its own rows
of the output.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import trace
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.models.common import (ModelConfig, col_in, dense_init,
                                       mlp_forward, mlp_init)

GROUP = 4096      # tokens per dispatch group


def moe_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": dense_init(gen, (d, E), torch.float32),
         "wi_up": dense_init(gen, (E, d, f), cfg.adtype),
         "wo": dense_init(gen, (E, f, d), cfg.adtype)}
    if cfg.mlp == "swiglu":
        p["wi_gate"] = dense_init(gen, (E, d, f), cfg.adtype)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, the lower index first on ties
    (a stable descending sort: ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_forward(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, d) -> (y, aux_loss)."""
    R = sh.ranks()
    if R is not None and (R.M > 1 or (R.D > 1 and sh.is_batch_split())):
        return _moe_mesh(cfg, p, x, R)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    g = min(GROUP, T)
    if T % g:
        raise ValueError(f"{T} tokens do not split into groups of {g}")
    G = T // g
    xt = x.reshape(G, g, d)

    logits = xt.float() @ p["router"]                            # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)                     # (G, g, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    cap = max(int(math.ceil(g * k / E * cfg.capacity_factor)), 1)
    onehot = F.one_hot(expert_idx, E)                            # (G, g, k, E)
    flat = onehot.reshape(G, g * k, E)
    pos = torch.cumsum(flat, dim=1) - flat                       # (G, g·k, E)
    pos = (pos * flat).sum(-1).reshape(G, g, k)                  # (G, g, k)
    keep = pos < cap
    if trace.active():      # (token, expert) pairs past the capacity
        trace.count("lm.moe.dropped", (~keep).sum())
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]
    disp = torch.einsum("gtke,gtkc->gtec", onehot.to(xt.dtype),
                        pos_oh.to(xt.dtype))
    comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot.float(),
                        pos_oh.float(), gate_vals.float()).to(xt.dtype)

    xe = torch.einsum("gtd,gtec->gecd", xt, disp)                # (G, E, C, d)
    if cfg.mlp == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wi_gate"])) \
            * torch.einsum("gecd,edf->gecf", xe, p["wi_up"])
    else:
        h = torch.square(torch.relu(
            torch.einsum("gecd,edf->gecf", xe, p["wi_up"])))
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"])              # (G, E, C, d)
    y = torch.einsum("gecd,gtec->gtd", ye, comb)

    # load-balance aux loss (Switch-style)
    density = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    density_proxy = probs.mean(dim=(0, 1))
    aux = E * torch.sum(density * density_proxy)
    return y.reshape(B, S, d), aux


def shared_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """A routed MoE under ``moe`` (``moe_init``'s leaves, each expert's
    matrices of standard deviation 1/√fan-in of the expert, where
    ``moe_init`` divides by √E as the reference does) and, under
    ``shared``, the shared expert: a SwiGLU MLP of width
    ``cfg.shared_ff`` that every token takes."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    moe = {"router": dense_init(gen, (d, E), torch.float32),
           "wi_up": dense_init(gen, (E, d, f), cfg.adtype, in_axis=1),
           "wo": dense_init(gen, (E, f, d), cfg.adtype, in_axis=1),
           "wi_gate": dense_init(gen, (E, d, f), cfg.adtype, in_axis=1)}
    return {"moe": moe, "shared": mlp_init(cfg, gen, d_ff=cfg.shared_ff)}


def shared_forward(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The routed experts' output plus the shared expert's, counted once:
    (y, aux_loss)."""
    y, aux = moe_forward(cfg, p["moe"], x)
    return y + mlp_forward(cfg, p["shared"], x), aux


def _routing(cfg: ModelConfig, probs: torch.Tensor, g: int):
    """top-k, the renormalized gates, the capacity, the dispatch and
    combine tensors of one routing (G, g, E), as ``moe_forward``."""
    E, k = cfg.num_experts, cfg.experts_per_token
    G = probs.shape[0]
    gate_vals, expert_idx = _top_k(probs, k)                     # (G, g, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    cap = max(int(math.ceil(g * k / E * cfg.capacity_factor)), 1)
    onehot = F.one_hot(expert_idx, E)                            # (G, g, k, E)
    flat = onehot.reshape(G, g * k, E)
    pos = torch.cumsum(flat, dim=1) - flat                       # (G, g·k, E)
    pos = (pos * flat).sum(-1).reshape(G, g, k)                  # (G, g, k)
    keep = pos < cap
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]
    return expert_idx, onehot, pos_oh, gate_vals


def _moe_mesh(cfg: ModelConfig, p: dict, x: torch.Tensor, R):
    """``moe_forward`` on a mesh (module docstring)."""
    B, S, d = x.shape
    E = cfg.num_experts
    gm = R.model_group
    split_rows = R.D > 1 and sh.is_batch_split()
    g = min(GROUP, B * S * (R.D if split_rows else 1))
    own = split_rows and (B * S) % g == 0     # this rank's rows: whole groups
    gather = split_rows and not own           # the groups span the ranks' rows
    if gather:
        x = coll.gather_fsdp(x, R.batch_group, R.D, R.d, 0)
    Bg = x.shape[0]
    T = Bg * S
    if T % g:
        raise ValueError(f"{T} tokens do not split into groups of {g}")
    G = T // g
    xt = x.reshape(G, g, d)
    xt = sh.shard(xt, "batch", None, None,
                  full=(G * R.D if own else None, g, d))
    es = R.split(E)                         # experts over model
    fs = not es and R.split(cfg.d_ff)       # else each expert's ff
    xc = col_in(xt, gm) if es or fs else xt
    if es:
        logits = coll.gather_from(xc.float() @ p["router"], gm, R.M, R.m, 2)
    else:
        logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    expert_idx, onehot, pos_oh, gate_vals = _routing(cfg, probs, g)
    disp = torch.einsum("gtke,gtkc->gtec", onehot.to(xt.dtype),
                        pos_oh.to(xt.dtype))
    comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot.float(),
                        pos_oh.float(), gate_vals.float()).to(xt.dtype)
    if es or fs:
        comb = coll.copy_to(comb.to(xc.dtype), gm)
    if es:
        e = R.part(E)
        disp, comb = disp[:, :, e], comb[:, :, e]

    xe = torch.einsum("gtd,gtec->gecd", xc,
                      disp.to(xc.dtype)).to(xt.dtype)            # (G, El, C, d)
    xe = sh.shard(xe, "batch", "experts", None, None,
                  full=(None, E, None, d) if es else None)
    if cfg.mlp == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wi_gate"])) \
            * torch.einsum("gecd,edf->gecf", xe, p["wi_up"])
    else:
        h = torch.square(torch.relu(
            torch.einsum("gecd,edf->gecf", xe, p["wi_up"])))
    h = sh.shard(h, "batch", "experts", None, "ff",
                 full=(None, E, None, cfg.d_ff) if es or fs else None)
    if fs:              # each expert's ff split: partial sums in float32
        ye = torch.einsum("gecf,efd->gecd", h.to(xc.dtype),
                          p["wo"].to(xc.dtype))
    else:
        ye = torch.einsum("gecf,efd->gecd", h, p["wo"])          # (G, El, C, d)
    ye = sh.shard(ye, "batch", "experts", None, None,
                  full=(None, E, None, d) if es else None)
    if es or fs:        # a partial sum over experts (or ff), all-reduced
        y = coll.reduce_from(torch.einsum("gecd,gtec->gtd",
                                          ye.to(xc.dtype), comb), gm)
        y = y.to(xt.dtype)
    else:
        y = torch.einsum("gecd,gtec->gtd", ye, comb)
    y = y.reshape(Bg, S, d)
    if gather:
        y = y[R.d * B:(R.d + 1) * B]

    density = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    density_proxy = probs.mean(dim=(0, 1))
    if own:     # the global means: every data rank holds G of the D·G groups
        both = coll.sum_over(torch.stack([density, density_proxy]),
                             R.batch_group) / R.D
        density, density_proxy = both[0], both[1]
    aux = E * torch.sum(density * density_proxy)
    return y, aux
