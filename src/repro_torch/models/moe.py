"""Mixture-of-Experts FFN — counterpart of ``repro/models/moe.py``:
token-choice top-k router, GShard-style grouped capacity dispatch.

Tokens are split into groups of ``GROUP``; each group computes its own
(g, E, C) dispatch / combine pair with C = ⌈g·k/E·cf⌉, so dispatch memory
scales linearly in tokens.  The router and the combine run in float32
whatever the activation dtype, as the reference's.  Ties among router
probabilities go to the lower expert index (``jax.lax.top_k``'s order),
and capacity positions count (token, k) pairs in the reference's
flattening, so the same tokens are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init

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
