"""A plain reference of GraniteMoeHybrid's forward pass (Granite 4.0-H), in
float32 ``torch`` with no cache, no batching and no kernels, and the
random weights it is checked on.

It follows the published description (the model's ``config.json`` and the
layer equations of ``transformers``' ``granitemoehybrid``).  For layer ℓ
of kind ``layer_types[ℓ]``:

    x ← x + r · mixer_ℓ(rms(x))
    x ← x + r · (moe_ℓ(rms(x)) + shared_ℓ(rms(x)))

with r = ``residual_multiplier``; the embedding is multiplied by
``embedding_multiplier``, the tied head's logits divided by
``logits_scaling``.

- Mamba-2 (``n_groups`` 1): in_proj → z | x B C | dt; a depthwise causal
  conv of ``mamba_d_conv`` taps with bias over x B C, then SiLU;
  dt = softplus(dt + dt_bias), A = −exp(A_log); the state
  h (heads, d_head, d_state) runs the plain recurrence, token by token:
  h ← exp(dt·A)·h + dt·x ⊗ B, y = h·C + D·x; then y·SiLU(z), an RMSNorm
  over all ``mamba_expand``·d channels, out_proj.
- Attention: GQA with no positional encoding, scores scaled by
  ``attention_multiplier``, causal softmax, no bias.
- MoE: router logits (float32) → the top ``num_experts_per_tok`` →
  softmax over those k (GraniteMoe's gating); each routed SwiGLU expert
  of width ``intermediate_size`` runs on the tokens that chose it; the
  shared SwiGLU expert of width ``shared_intermediate_size`` on every
  token.

The weights come from :func:`draw`, from a seed, in a layout of this file:
a dict a layer with ``transformers``' norm names and one matrix a
projection (``in_proj`` packs z | x | B | C | dt; each SwiGLU's gate and
up are separate matrices where ``transformers`` stacks them in one
``input_linear``).  A program under test is given the same draw and loads
it into its own layout.

Departures from the published description:
- ``intermediate_size`` is read as one routed expert's width (the config
  has no key of its own for it; an inference).
- The weights are random (:func:`draw`), not the published checkpoint.
- ``cast`` may round each weight before use (the low-precision control);
  by default weights are only widened to float32.  ``state_dtype`` may
  run the recurrence from token ``state_from`` on in a lower precision
  (the control of a state kept one precision down).
- Only the logits of the asked positions are computed, and no RoPE,
  dropout, padding mask or ``time_step_limit`` (its default (0, ∞) clips
  nothing) enters.

Imports nothing but ``torch``.  The same file lies at
``tests/ref_granite_hybrid.py`` and ``bench/reference/granite_hybrid.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: leaves :func:`draw` keeps in float32 (the router and the SSD's A, dt
#: bias and D); it stores every other leaf in its ``dtype``
FLOAT32 = ("router", "a_log", "dt_bias", "d_skip")


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Random weights of ``cfg`` (the published keys, its first
    ``num_hidden_layers`` ``layer_types``) from ``seed``: ``embed``,
    ``final_norm`` and ``layers``, a dict a layer in order.

    The embedding and every projection (each expert's too) are normal of
    standard deviation 1/√fan-in (the embedding's fan-in is the
    vocabulary), the conv taps of 1/√d_conv; norms and D are 1; the conv
    bias is uniform in ±1/√d_conv; A is uniform in [1, 16] (``a_log`` =
    log A) and dt log-uniform in [0.001, 0.1] (``dt_bias`` its inverse
    softplus), as Mamba-2 initialises them.  Each leaf is drawn in float32
    on ``device`` by a generator of its own, seeded from ``seed`` and the
    leaf's place, and stored in ``dtype`` but :data:`FLOAT32`: a draw of
    one seed gives the same numbers each time."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    d_in, H = cfg["mamba_expand"] * d, cfg["mamba_n_heads"]
    n, K = cfg["mamba_d_state"], cfg["mamba_d_conv"]
    Hq, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // Hq
    E, f = cfg["num_local_experts"], cfg["intermediate_size"]
    fs = cfg["shared_intermediate_size"]
    place = iter(range(1 << 20))

    def gen():
        return torch.Generator(device=device).manual_seed(
            (int(seed) % (1 << 40)) << 20 | next(place))

    def normal(*shape, fan_in):
        return torch.randn(shape, generator=gen(), device=device,
                           dtype=torch.float32) / math.sqrt(fan_in)

    def uniform(size, lo, hi):
        return lo + (hi - lo) * torch.rand((size,), generator=gen(),
                                           device=device, dtype=torch.float32)

    def ones(size):
        return torch.ones((size,), device=device, dtype=torch.float32)

    def stored(p):
        return {k: v if k == "kind" or k in FLOAT32 else v.to(dtype)
                for k, v in p.items()}

    layers = []
    for kind in cfg["layer_types"][:cfg["num_hidden_layers"]]:
        if kind == "mamba":
            dt = torch.exp(uniform(H, math.log(1e-3), math.log(1e-1)))
            p = {"in_proj": normal(d, 2 * d_in + 2 * n + H, fan_in=d),
                 "conv_w": normal(K, d_in + 2 * n, fan_in=K),
                 "conv_b": uniform(d_in + 2 * n, -1.0, 1.0) / math.sqrt(K),
                 "a_log": torch.log(uniform(H, 1.0, 16.0)),
                 "dt_bias": dt + torch.log(-torch.expm1(-dt)),
                 "d_skip": ones(H), "norm_w": ones(d_in),
                 "out_proj": normal(d_in, d, fan_in=d_in)}
        else:
            p = {"wq": normal(d, Hq * hd, fan_in=d),
                 "wk": normal(d, KV * hd, fan_in=d),
                 "wv": normal(d, KV * hd, fan_in=d),
                 "wo": normal(Hq * hd, d, fan_in=Hq * hd)}
        p.update(kind=kind, input_layernorm=ones(d),
                 post_attention_layernorm=ones(d),
                 router=normal(d, E, fan_in=d),
                 experts_gate=normal(E, d, f, fan_in=d),
                 experts_up=normal(E, d, f, fan_in=d),
                 experts_down=normal(E, f, d, fan_in=f),
                 shared_gate=normal(d, fs, fan_in=d),
                 shared_up=normal(d, fs, fan_in=d),
                 shared_down=normal(fs, d, fan_in=fs))
        layers.append(stored(p))
    return {"embed": normal(V, d, fan_in=V).to(dtype),
            "final_norm": ones(d).to(dtype), "layers": layers}


def _f32(t):
    return t.to(torch.float32)


def rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def granite_gates(logits, k: int):
    """GraniteMoe's routing: the top k of the router's logits, then a
    softmax over those k.  Returns (gates, expert indices), each (T, k)."""
    vals, idx = torch.topk(logits, k, dim=-1)
    return torch.softmax(vals, dim=-1), idx


def mamba(cfg: dict, p: dict, x, W, state_dtype=None, state_from: int = 0):
    """Mamba-2 over one sequence x (S, d), the recurrence token by token;
    with ``state_dtype``, the recurrence of each token from ``state_from``
    on runs in that dtype (h, its decay and its increment)."""
    S, d = x.shape
    d_in = cfg["mamba_expand"] * d
    H, hd = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n, K = cfg["mamba_d_state"], cfg["mamba_d_conv"]
    z, xbc, dt = torch.split(x @ W(p["in_proj"]), [d_in, d_in + 2 * n, H],
                             dim=-1)
    w, b = W(p["conv_w"]), W(p["conv_b"])
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = F.silu(sum(xp[i:i + S] * w[i] for i in range(K)) + b)
    xs, Bm, Cm = torch.split(xbc, [d_in, n, n], dim=-1)
    xs = xs.reshape(S, H, hd)
    dt = F.softplus(dt + _f32(p["dt_bias"]))                      # (S, H)
    A = -torch.exp(_f32(p["a_log"]))
    h = torch.zeros((H, hd, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[t] * A)[:, None, None]
        dh = (dt[t][:, None, None] * xs[t][:, :, None]) * Bm[t]
        if state_dtype is not None and t >= state_from:
            h = (h.to(state_dtype) * decay.to(state_dtype)
                 + dh.to(state_dtype)).float()
        else:
            h = h * decay + dh
        ys.append(h @ Cm[t])
    y = torch.stack(ys) + xs * _f32(p["d_skip"])[:, None]
    y = y.reshape(S, d_in) * F.silu(z)
    y = rms(y, W(p["norm_w"]), cfg["rms_norm_eps"])
    return y @ W(p["out_proj"])


def attention(cfg: dict, p: dict, x, W):
    """Causal GQA over one sequence x (S, d), no positional encoding."""
    S, d = x.shape
    Hq, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // Hq
    q = (x @ W(p["wq"])).reshape(S, Hq, hd)
    k = (x @ W(p["wk"])).reshape(S, KV, hd).repeat_interleave(Hq // KV, 1)
    v = (x @ W(p["wv"])).reshape(S, KV, hd).repeat_interleave(Hq // KV, 1)
    s = torch.einsum("qhd,khd->hqk", q, k) * cfg["attention_multiplier"]
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return out.reshape(S, Hq * hd) @ W(p["wo"])


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe(cfg: dict, p: dict, x, W):
    """The routed experts' sum over x (T, d) plus the shared expert's."""
    gates, idx = granite_gates(x @ _f32(p["router"]),
                               cfg["num_experts_per_tok"])
    out = torch.zeros_like(x)
    for e in range(cfg["num_local_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], W(p["experts_gate"][e]),
                       W(p["experts_up"][e]), W(p["experts_down"][e]))
            out.index_add_(0, rows, y * gates[rows, slot, None])
    return out + swiglu(x, W(p["shared_gate"]), W(p["shared_up"]),
                        W(p["shared_down"]))


def forward(cfg: dict, weights: dict, tokens, positions=None, cast=None,
            state_dtype=None, state_from: int = 0):
    """Logits (len(positions), V) in float32 of one sequence ``tokens``
    (S,) at ``positions`` (every position when None).  ``cfg`` holds the
    published keys; ``weights`` is :func:`draw`'s dict, whose layers run
    in order; ``cast`` rounds a weight before use (None: none);
    ``state_dtype`` runs each Mamba recurrence from token ``state_from``
    on in that dtype (None: float32)."""
    def W(t):
        return _f32(t if cast is None else cast(t))

    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = W(weights["embed"])[tokens] * cfg["embedding_multiplier"]
    for p in weights["layers"]:
        h = rms(x, W(p["input_layernorm"]), eps)
        if p["kind"] == "mamba":
            h = mamba(cfg, p, h, W, state_dtype, state_from)
        else:
            h = attention(cfg, p, h, W)
        x = x + r * h
        x = x + r * moe(cfg, p, rms(x, W(p["post_attention_layernorm"]),
                                     eps), W)
    if positions is not None:
        x = x[torch.as_tensor(positions, device=x.device)]
    x = rms(x, W(weights["final_norm"]), eps)
    return (x @ W(weights["embed"]).T) / cfg["logits_scaling"]
