"""Mamba2 SSD (state-space duality) block — counterpart of
``repro/models/ssm.py``: the chunked, matmul-dominant form.

The chunked SSD algorithm (arXiv:2405.21060 §6) splits the selective scan
into intra-chunk attention-like products plus an inter-chunk state
recurrence; the reference carries that recurrence, and the few-token
decode recurrence, with ``lax.scan``, the port with a Python loop
(``hlo_cost.loop``: under the cost counter on fake tensors one step,
counted as many times as the loop runs, the reference's trip-count
rule).  The
decode state is O(1) in sequence length: ``h`` (B, H, hd, n) and the
convolution's last K−1 inputs ``conv`` (B, K−1, C).  ``a_log``,
``dt_bias`` and ``d_skip`` stay float32 whatever the activation dtype.

Under a mesh the heads split over ``model``.  ``in_proj`` packs its
output as z | x | B | C | dt, which an even column split does not line
up with: a rank holds its heads' part of z, x and dt and the whole of B
and C (one group), the packed layout ``distributed/sharding.py`` calls
``segments`` (``in_proj``, ``conv_w`` and the cache's ``conv``: x | B |
C).  Every rank computes B and C, read by its heads only, so their
weights' gradients are summed over ``model`` (``collectives.copy_to``).
The norm over the d_in channels sums its squares over ``model``;
``out_proj`` is row-parallel, one all-reduce.  SSM heads that do not
split the model axis (``ssm_replicated``) run whole on every rank, from
whole weights and a whole state, the output added once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import hlo_cost
from repro_torch.distributed import sharding as sh
from repro_torch.models.common import (ModelConfig, col_in, col_mm,
                                       dense_init, rmsnorm, row_out)


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_state


def ssm_replicated(cfg: ModelConfig, M: int) -> bool:
    """Whether the SSM heads do not split over a model axis of ``M``: the
    layer then runs whole on every rank (the reference's ``constrain``
    replicates them), its leaves and its cache placed whole over
    ``model``."""
    return M > 1 and ssm_dims(cfg)[1] % M != 0


def ssm_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d = cfg.d_model
    d_in, nheads, nstate = ssm_dims(cfg)
    conv_dim = d_in + 2 * nstate
    dev = gen.device

    def full(n, value, dtype):
        return torch.full((n,), value, dtype=dtype, device=dev)

    return {
        "in_proj": dense_init(gen, (d, 2 * d_in + 2 * nstate + nheads),
                              cfg.adtype),
        "conv_w": dense_init(gen, (cfg.conv_kernel, conv_dim), cfg.adtype),
        "conv_b": full(conv_dim, 0.0, cfg.adtype),
        "a_log": full(nheads, 0.0, torch.float32),
        "dt_bias": full(nheads, 0.0, torch.float32),
        "d_skip": full(nheads, 1.0, torch.float32),
        "norm_w": full(d_in, 1.0, cfg.adtype),
        "out_proj": dense_init(gen, (d_in, d), cfg.adtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T) lower-triangular segment sums (−inf above
    the diagonal)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return ss.masked_fill(~mask, float("-inf"))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d. x: (B, S, C), w: (K, C), state: (B, K−1, C)
    (the previous inputs, or zeros when None).  Returns (out, new_state)."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1], :] * w[i] for i in range(K))
    return out + b, xp[:, -(K - 1):, :]


def ssm_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, *, state=None):
    """x: (B, S, d).  ``state``: dict(h, conv) to run the recurrence from
    (prefill into a cache, decode), or None for the chunked form over a
    whole sequence.  Returns (y, new_state), new_state None without a
    state."""
    R = sh.ranks()
    if R is not None and R.M > 1 and not ssm_replicated(cfg, R.M):
        return _ssm_tp(cfg, p, x, R, state)
    B, S, _ = x.shape
    d_in, nheads, nstate = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"]
    z, xs, Bmat, Cmat, dt = torch.split(
        zxbcdt, [d_in, d_in, nstate, nstate, nheads], dim=-1)
    conv_in = torch.cat([xs, Bmat, Cmat], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        None if state is None else state["conv"])
    conv_out = F.silu(conv_out)
    xs, Bmat, Cmat = torch.split(conv_out, [d_in, nstate, nstate], dim=-1)
    xs = xs.reshape(B, S, nheads, hd)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,S,H)
    a = -torch.exp(p["a_log"])                                    # (H,)
    dA = dt * a                                                   # (B,S,H)
    y, new_state = _scan(cfg, xs, Bmat, Cmat, dA, dt, state, conv_state)
    y = y + xs * p["d_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, d_in)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], new_state


def _scan(cfg: ModelConfig, xs, Bmat, Cmat, dA, dt, state, conv_state):
    """The SSD over (B, S, H, hd): from ``state["h"]``, the chunked form
    for a prefill and the recurrence for a decode step; without a state,
    the chunked form.  Returns (y, new_state)."""
    S = xs.shape[1]

    if state is not None and S > 1:
        y, h = _ssd_chunked(cfg, xs, Bmat, Cmat, dA, dt, h0=state["h"])
        new_state = {"h": h.to(state["h"].dtype), "conv": conv_state}
    elif state is not None:
        # the reference's lax.scan over tokens, in the state's dtype
        # (``cfg.ssm_state_dtype``); y in the input's
        h = state["h"]                                            # (B,H,hd,n)
        f = h.dtype
        ys = []
        for t in hlo_cost.loop(S, "ssd_recurrence"):
            xt, bt, ct = xs[:, t].to(f), Bmat[:, t].to(f), Cmat[:, t].to(f)
            dh = torch.einsum("bhd,bn,bh->bhdn", xt, bt, dt[:, t].to(f))
            h = h * torch.exp(dA[:, t])[:, :, None, None].to(f) + dh
            ys.append(torch.einsum("bhdn,bn->bhd", h, ct).to(xs.dtype))
        y = hlo_cost.stack(ys, S, dim=1)                          # (B,S,H,hd)
        new_state = {"h": h, "conv": conv_state}
    else:
        y = _ssd_chunked(cfg, xs, Bmat, Cmat, dA, dt)
        new_state = None
    return y, new_state


def packed_segments(cfg: ModelConfig, leaf: str) -> tuple:
    """The packed dimension's segments ((size, split over heads), ...) of
    ``in_proj`` (z | x | B | C | dt) or ``conv_w`` / the cache's ``conv``
    (x | B | C)."""
    d_in, nheads, nstate = ssm_dims(cfg)
    xbc = ((d_in, True), (nstate, False), (nstate, False))
    if leaf == "in_proj":
        return ((d_in, True),) + xbc + ((nheads, True),)
    return xbc


def _packed(w, cfg: ModelConfig, leaf: str, R) -> torch.Tensor:
    """A rank's compute block of a packed leaf along its last dimension:
    its heads' part of each split segment, the whole of each replicated
    one read through ``copy_to``.  ``w`` is the rank's placement block
    (segmented when the placement splits the dimension) or the whole
    leaf."""
    segs = packed_segments(cfg, leaf)
    g, dim = R.model_group, w.ndim - 1
    whole = w.shape[-1] == sum(size for size, _ in segs)
    parts = w.split([size if whole or not split else size // R.M
                     for size, split in segs], dim)
    return torch.cat(
        [(coll.scatter_to(t, g, R.M, R.m, dim) if whole else t) if split
         else coll.copy_to(t, g) for t, (_, split) in zip(parts, segs)],
        dim=dim)


def _ssm_tp(cfg: ModelConfig, p: dict, x: torch.Tensor, R, state):
    """``ssm_forward`` on a mesh: this rank's heads (module docstring)."""
    B, S, _ = x.shape
    d_in, nheads, nstate = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    g = R.model_group
    Hl, dl = nheads // R.M, d_in // R.M

    def heads(t):           # a replicated (H,)-vector's block
        return coll.scatter_to(t, g, R.M, R.m, 0)

    zxbcdt = col_mm(col_in(x, g), _packed(p["in_proj"], cfg, "in_proj", R),
                    x.dtype)
    z, xs, Bmat, Cmat, dt = torch.split(
        zxbcdt, [dl, dl, nstate, nstate, Hl], dim=-1)
    conv_in = torch.cat([xs, Bmat, Cmat], dim=-1)
    conv_b = torch.cat([heads(p["conv_b"][:d_in]),
                        coll.copy_to(p["conv_b"][d_in:], g)])
    if state is not None and state["conv"].shape[-1] != dl + 2 * nstate:
        raise NotImplementedError(
            f"{cfg.name}: a conv cache of {state['conv'].shape[-1]} channels"
            f" a rank: the cache's channels must split over the model axis")
    conv_out, conv_state = _causal_conv(
        conv_in, _packed(p["conv_w"], cfg, "conv_w", R), conv_b,
        None if state is None else state["conv"])
    conv_out = F.silu(conv_out)
    xs, Bmat, Cmat = torch.split(conv_out, [dl, nstate, nstate], dim=-1)
    xs = xs.reshape(B, S, Hl, hd)
    xs = sh.shard(xs, "batch", "seq", "heads", None,
                  full=(None, S, nheads, hd))
    dt = F.softplus(dt.float() + heads(p["dt_bias"]))             # (B,S,Hl)
    dA = dt * -torch.exp(heads(p["a_log"]))
    y, new_state = _scan(cfg, xs, Bmat, Cmat, dA, dt, state, conv_state)
    y = y + xs * heads(p["d_skip"])[None, None, :, None].to(y.dtype)
    y = (y.reshape(B, S, dl) * F.silu(z)).float()
    # rmsnorm over all d_in channels: the squares summed over model
    ms = coll.sum_over(torch.sum(y * y, dim=-1, keepdim=True), g) / d_in
    y = y * torch.rsqrt(ms + cfg.norm_eps)
    y = (y * heads(p["norm_w"]).float()).to(x.dtype)
    return row_out(y, p["out_proj"], g), new_state


def _ssd_chunked(cfg: ModelConfig, xs, Bmat, Cmat, dA, dt, h0=None):
    """Chunked SSD: intra-chunk products + the inter-chunk recurrence.

    xs: (B, S, H, hd), Bmat / Cmat: (B, S, n), dA / dt: (B, S, H) float32.
    S is right-padded to a multiple of the chunk; padded steps come after
    every real one, so they cannot reach y[:, :S], and they neither decay
    nor add to the state (dA = dt = 0).  With ``h0`` (B, H, hd, n), the
    state before the first token, returns (y, the state after the last
    token); else y."""
    B, S, H, hd = xs.shape
    n = Bmat.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    S_out = S
    pad = (-S) % Q
    if pad:
        def padf(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        xs, Bmat, Cmat, dA, dt = map(padf, (xs, Bmat, Cmat, dA, dt))
        S = S + pad
    nc = S // Q

    def r(t):
        return t.reshape(B, nc, Q, *t.shape[2:])

    xs_c, B_c, C_c = r(xs), r(Bmat), r(Cmat)
    dA_c, dt_c = r(dA), r(dt)                                    # (B,nc,Q,H)
    dA_h = dA_c.permute(0, 1, 3, 2)                              # (B,nc,H,Q)
    # intra-chunk: Y = (C B^T ⊙ L) (dt·X)
    L = torch.exp(_segsum(dA_h))                                 # (B,nc,H,Q,Q)
    CB = torch.einsum("bcqn,bcsn->bcqs", C_c, B_c)               # (B,nc,Q,Q)
    M = CB[:, :, None] * L                                       # (B,nc,H,Q,Q)
    dtx = xs_c * dt_c[..., None].to(xs_c.dtype)                  # (B,nc,Q,H,hd)
    y_intra = torch.einsum("bchqs,bcshd->bcqhd", M.to(xs_c.dtype), dtx)
    # chunk states: h_c = Σ_s exp(A_end − A_s) dt_s B_s x_s
    Aend = torch.cumsum(dA_h, dim=-1)
    decay_to_end = torch.exp(Aend[..., -1:] - Aend)              # (B,nc,H,Q)
    st = torch.einsum("bchq,bcqhd,bcqn->bchdn",
                      decay_to_end.to(xs_c.dtype), dtx, B_c)     # (B,nc,H,hd,n)
    chunk_decay = torch.exp(Aend[..., -1])                       # (B,nc,H)

    # the reference's lax.scan over chunks: h_prev of each chunk
    h = (torch.zeros((B, H, hd, n), dtype=xs.dtype, device=xs.device)
         if h0 is None else h0.to(xs.dtype))
    h_prevs = []
    for c in hlo_cost.loop(nc, "ssd_chunks"):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None].to(h.dtype) + st[:, c]
    h_prevs = hlo_cost.stack(h_prevs, nc, dim=1)                 # (B,nc,H,hd,n)
    # inter-chunk: y += C_t · (decay_from_start · h_prev)
    decay_in = torch.exp(Aend)                                   # (B,nc,H,Q)
    y_inter = torch.einsum("bcqn,bchdn,bchq->bcqhd", C_c, h_prevs,
                           decay_in.to(xs_c.dtype))
    y = (y_intra + y_inter).reshape(B, S, H, hd)[:, :S_out]
    return y if h0 is None else (y, h)


def ssm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_in, nheads, nstate = ssm_dims(cfg)
    conv_dim = d_in + 2 * nstate
    return {
        "h": torch.zeros((batch, nheads, cfg.ssm_head_dim, nstate),
                         dtype=cfg.ssm_state_dtype or dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
    }
