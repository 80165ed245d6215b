"""Model zoo substrate — counterpart of ``repro/models/common.py``:
``ModelConfig``, the initializer, norms, RoPE, attention (one masked
softmax for decode, online softmax over KV blocks otherwise) and the MLP
variants.  Parameters are dicts of tensors under the reference pytree's
names; the products stay plain ``torch.matmul`` / ``einsum``, as the
reference computes them in plain ``jnp`` outside any Pallas kernel.

Under a mesh (``distributed/sharding.py``'s current rules) a layer holds
its rank's blocks and runs Megatron-style: ``wq`` / ``wk`` / ``wv`` /
``wi_*`` column-parallel over heads / KV heads / ``ff``, ``wo``
row-parallel with one all-reduce over ``model`` after it
(``distributed/collectives.py``).  When the KV heads do not divide the
model axis the reference replicates K/V while the Q heads stay split: a
rank then computes every KV head and attends with those its local Q
heads read; the serve cache holds a block of the sequence instead
(``seq_sp``, in blocks of ⌈L / model⌉), and a decode step, or a prefill
chunk that starts past position 0, combines the ranks' partial softmaxes
(flash-decoding: the maximum, then the sums, all-reduced).  When the Q
heads do not divide the model axis, or a rank's Q heads would not group
evenly over the KV heads (``attn_replicated``), the reference's
``constrain`` drops the axis and replicates the heads: every rank then
holds the whole ``wq`` / ``wk`` / ``wv`` / ``wo``, computes every head
with the one-device code and adds the block's output once, with no
all-reduce over ``model`` (a decode step or a later prefill chunk still
combines the ranks' partial softmaxes over the sequence-split cache).
The reference's ``shard`` constraints are called at its points and check
the local shapes.  Without a mesh every layer runs the one-device code.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import hlo_cost
from repro_torch.distributed import sharding as sh


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0          # 0 -> = num_heads (MHA)
    head_dim: int = 0              # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    ssm_chunk: int = 128
    # hybrid (zamba2-style): one shared attention block every `attn_period`
    # ssm layers; num_layers counts ssm layers + attn layers together.
    attn_period: int = 0
    # VLM: cross-attention to frontend embeddings every `cross_attn_period`
    cross_attn_period: int = 0
    frontend_tokens: int = 0       # stub modality input length
    frontend_dim: int = 0
    # attention / MLP details
    qkv_bias: bool = False
    mlp: str = "swiglu"            # swiglu | squared_relu | gelu
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    attn_block: int = 1024         # blockwise-attention KV tile
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    # secure (paper integration): indices of layers whose projections run
    # under HE MM in secure-inference mode (repro_torch.serve)
    secure_layers: tuple = ()

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def adtype(self) -> torch.dtype:
        """The activation dtype named by ``dtype`` (a ``torch.dtype``)."""
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"dtype={self.dtype!r} names no torch dtype")
        return dt

    def param_count(self) -> int:
        """Approximate parameter count (used in MODEL_FLOPS and reports)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.kv_heads, self.hdim
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        if self.mlp == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.num_experts:
            mlp = self.num_experts * mlp + d * self.num_experts
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            din = self.ssm_expand * d
            nheads = din // self.ssm_head_dim
            ssm = (d * (2 * din + 2 * self.ssm_state + nheads)
                   + din * self.conv_kernel + din * d)
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per_layer = ssm
        elif self.family == "hybrid":
            na = self.num_attn_layers()
            ns = self.num_layers - na
            return (ns * ssm + na * (attn + mlp) + emb)
        else:
            per_layer = attn + mlp
        return self.num_layers * per_layer + emb

    def num_attn_layers(self) -> int:
        if self.family != "hybrid" or not self.attn_period:
            return 0
        return self.num_layers // self.attn_period

    # settings a subclass may change; not fields, so ``asdict`` of every
    # configuration stays the reference's
    @property
    def softmax_scale(self) -> float:
        """The attention scores' scale."""
        return 1.0 / math.sqrt(self.hdim)

    @property
    def rotary(self) -> bool:
        """Whether attention applies RoPE to Q and K."""
        return True

    @property
    def embedding_multiplier(self) -> float:
        """The embedding's scale."""
        return 1.0

    @property
    def logits_scaling(self) -> float:
        """The divisor of the head's logits."""
        return 1.0

    @property
    def ssm_state_dtype(self):
        """The dtype of the Mamba state ``h`` in a serve cache (None: the
        activations')."""
        return None


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """A hybrid of Mamba-2 and attention layers, each followed by a routed
    MoE and a shared expert (GraniteMoeHybrid, family ``hybrid_moe``).

    ``layer_pattern`` is one period of mixers, ``"mamba"`` or
    ``"attention"`` at their published offsets; ``num_layers`` is a whole
    number of periods, and a block of ``models/transformer.py`` is one
    period.  Layer ℓ:  x ← x + r·mixer(rms(x));  x ← x + r·(moe(rms(x)) +
    shared(rms(x))), r = ``residual_multiplier``.  The embedding is scaled
    by ``embedding_multiplier``, the logits divided by ``logits_scaling``.
    Attention has no positional encoding (``position_embedding`` "nope")
    and scales its scores by ``attention_multiplier``.  ``d_ff`` is one
    routed expert's width, ``shared_ff`` the shared expert's.  The cache
    keeps the Mamba state ``h`` in float32: stored in bfloat16, a decay
    exp(dt·A) above 1 − 2⁻⁹ rounds to 1, and a decode drifts from the
    float32 model step by step."""

    layer_pattern: tuple = ()
    shared_ff: int = 0
    position_embedding: str = "nope"
    attention_multiplier: float = 0.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    @property
    def softmax_scale(self) -> float:
        return self.attention_multiplier or 1.0 / math.sqrt(self.hdim)

    @property
    def rotary(self) -> bool:
        return self.position_embedding == "rope"

    @property
    def ssm_state_dtype(self):
        return torch.float32

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.kv_heads, self.hdim
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        din = self.ssm_expand * d
        nheads = din // self.ssm_head_dim
        ssm = (d * (2 * din + 2 * self.ssm_state + nheads)
               + (din + 2 * self.ssm_state) * (self.conv_kernel + 1)
               + din * d)
        ffn = (self.num_experts * 3 * d * f + d * self.num_experts
               + 3 * d * self.shared_ff)
        na = self.layer_pattern.count("attention")
        per = (na * attn + (len(self.layer_pattern) - na) * ssm
               + len(self.layer_pattern) * ffn)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.num_layers // len(self.layer_pattern) * per + emb


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               in_axis: int = 0) -> torch.Tensor:
    """Normal entries of standard deviation 1/√fan_in, drawn in float32
    from ``gen`` on its device, then cast to ``dtype``."""
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(shape[in_axis]))).to(dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D). Rotary embedding over the last dim; ``positions``
    (1, S) for a uniform batch or (B, 1) for per-slot decode positions."""
    half = x.shape[-1] // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].float() * freq               # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def decode_attention(q, k, v, kv_len, scale=None) -> torch.Tensor:
    """Sq=1 attention: one masked softmax over the full cache.

    q: (B, 1, H, D); k, v: (B, Skv, KV, D); kv_len: the slot last written —
    an int (uniform batch) or a (B,) tensor (continuous batching: slots
    admitted at different prompt lengths decode at different positions).
    Keys at positions > kv_len are masked, so the row just written at
    kv_len stays visible.  ``scale``: the scores' scale (1/√D when
    None)."""
    B, _, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * (
        1.0 / math.sqrt(D) if scale is None else scale)
    kpos = torch.arange(Skv, device=q.device)
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1).expand(B)
    mask = kpos[None, :] > kv_len[:, None]
    s = s.masked_fill(mask[:, None, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype), v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, D)


def blockwise_attention(q, k, v, *, causal: bool, q_offset=0,
                        block: int = 1024, scale=None) -> torch.Tensor:
    """Flash-style online-softmax attention over KV tiles of ``block``
    (Skv zero-padded to a whole number of tiles, the padding masked).

    Never materializes the (Sq, Skv) score matrix.  q: (B, Sq, H, D);
    k, v: (B, Skv, KV, D); query i sits at position ``q_offset + i``;
    ``scale``: the scores' scale (1/√D when None)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    if scale is None:       # applied in float32, as the reference
        scale = 1.0 / math.sqrt(D)
    nblk = max(1, (Skv + block - 1) // block)
    pad = nblk * block - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kb = k.reshape(B, nblk, block, KV, D)
    vb = v.reshape(B, nblk, block, KV, D)
    qg = q.reshape(B, Sq, KV, g, D)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, g, Sq), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, g, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, g, Sq, D), dtype=q.dtype, device=q.device)
    for j in hlo_cost.loop(nblk, "attn_kv_blocks"):
        kt, vt = kb[:, j], vb[:, j]
        kpos = j * block + torch.arange(block, device=q.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kt).float() * scale
        mask = (kpos[None, :] > qpos[:, None] if causal
                else torch.zeros((Sq, block), dtype=torch.bool,
                                 device=q.device))
        mask = mask | (kpos[None, :] >= Skv)
        s = s.masked_fill(mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vt.dtype), vt)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


_NARROW = (torch.bfloat16, torch.float16)


def col_in(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated activation entering column-parallel products
    (``copy_to``: its gradient summed over ``model``), in float32 when it
    is a 16-bit float, so a split product rounds once, as on one
    device."""
    return coll.copy_to(x.float() if x.dtype in _NARROW else x, group)


def col_mm(xc: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``xc @ w`` (``xc`` from :func:`col_in`) in the activation dtype."""
    return (xc @ w.to(xc.dtype)).to(dtype)


def row_out(h: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel product, its partial sums all-reduced over
    ``model`` (16-bit floats: computed and summed in float32, rounded
    once)."""
    if h.dtype in _NARROW:
        return coll.reduce_from(h.float() @ w.float(), group).to(h.dtype)
    return coll.reduce_from(h @ w, group)


def _mlp_act(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        return F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    if cfg.mlp == "squared_relu":
        return torch.square(torch.relu(x @ p["wi_up"]))
    return F.gelu(x @ p["wi_up"], approximate="tanh")


def mlp_forward(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    R = sh.ranks()
    if R is not None and R.M > 1:
        return _mlp_tp(cfg, p, x, R)
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    elif cfg.mlp == "squared_relu":
        h = torch.square(torch.relu(x @ p["wi_up"]))
    else:                       # jax.nn.gelu's default: the tanh form
        h = F.gelu(x @ p["wi_up"], approximate="tanh")
    return h @ p["wo"]


def _mlp_tp(cfg: ModelConfig, p: dict, x: torch.Tensor, R) -> torch.Tensor:
    """The MLP on a mesh: ``wi_*`` column-parallel and ``wo`` row-parallel
    over ``ff`` (one all-reduce), or whole on every rank when ``ff`` does
    not divide the model axis."""
    f = p["wo"].shape[0] * (R.M if R.split(cfg.d_ff) else 1)
    if not R.split(f):
        return _mlp_act(cfg, p, x) @ p["wo"]
    xc = col_in(x, R.model_group)
    up = col_mm(xc, p["wi_up"], x.dtype)
    if cfg.mlp == "swiglu":
        h = F.silu(col_mm(xc, p["wi_gate"], x.dtype)) * up
    elif cfg.mlp == "squared_relu":
        h = torch.square(torch.relu(up))
    else:
        h = F.gelu(up, approximate="tanh")
    h = sh.shard(h, "batch", "seq", "ff", full=(None, x.shape[1], f))
    return row_out(h, p["wo"], R.model_group)


def mlp_init(cfg: ModelConfig, gen: torch.Generator,
             d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi_up": dense_init(gen, (d, f), cfg.adtype),
         "wo": dense_init(gen, (f, d), cfg.adtype)}
    if cfg.mlp == "swiglu":
        p["wi_gate"] = dense_init(gen, (d, f), cfg.adtype)
    return p


def attn_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hdim
    p = {"wq": dense_init(gen, (d, h * hd), cfg.adtype),
         "wk": dense_init(gen, (d, kv * hd), cfg.adtype),
         "wv": dense_init(gen, (d, kv * hd), cfg.adtype),
         "wo": dense_init(gen, (h * hd, d), cfg.adtype)}
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((n,), dtype=cfg.adtype, device=gen.device)
    return p


def attn_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, positions,
                 *, kv_cache: Optional[dict] = None, cache_len=None,
                 kv_override=None, causal: bool = True):
    """Self-attention, causal unless ``causal=False``; returns (out,
    new_kv).  ``kv_cache``: dict(k, v) of (B, S_max, KV, hd), written IN
    PLACE at ``cache_len`` and returned: an int writes the S new rows from
    there (prefill, uniform decode), a (B,) tensor writes one row per slot
    at its own position (ragged decode, S == 1).  The writes must lie
    inside the cache.  ``kv_override``: (k, v) of (B, Skv, KV, hd) to
    attend to instead (cross-attention: no RoPE, no mask, no cache)."""
    R = sh.ranks()
    if R is None or R.M == 1:
        R = None                # one device
    elif not attn_replicated(cfg, R.M):
        return _attn_tp(cfg, p, x, positions, R, kv_cache=kv_cache,
                        cache_len=cache_len, kv_override=kv_override,
                        causal=causal)
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.kv_heads, cfg.hdim
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, h, hd)
    if kv_override is not None:
        k, v = kv_override
        out = blockwise_attention(q, k, v, causal=False, block=cfg.attn_block)
        return out.reshape(B, S, h * hd) @ p["wo"], None
    k, v = x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, S, kv, hd)
    if cfg.rotary:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    v = v.reshape(B, S, kv, hd)
    scale = cfg.softmax_scale
    if kv_cache is None:
        out = blockwise_attention(q, k, v, causal=causal,
                                  block=cfg.attn_block, scale=scale)
        return out.reshape(B, S, h * hd) @ p["wo"], None
    kc, vc = kv_cache["k"], kv_cache["v"]
    if R is not None:
        # heads replicated over model: every KV head, a block of the
        # sequence; a prefill from 0 attends to its own K/V, anything
        # later combines the ranks' partial softmaxes over the cache
        offset = _write_seq_split(kc, vc, k, v, cache_len, R)
        out = (blockwise_attention(q, k, v, causal=True,
                                   block=cfg.attn_block)
               if S > 1 and _from_zero(cache_len) else
               decode_attention_seq(q, kc, vc, cache_len, offset, R))
        return out.reshape(B, S, h * hd) @ p["wo"], kv_cache
    if isinstance(cache_len, torch.Tensor) and cache_len.ndim:
        if S != 1:
            raise ValueError("a per-slot cache_len is a decode-only path")
        rows = torch.arange(B, device=x.device)
        kc[rows, cache_len] = k[:, 0]
        vc[rows, cache_len] = v[:, 0]
    else:
        cl = int(cache_len)
        kc[:, cl:cl + S] = k
        vc[:, cl:cl + S] = v
    if S == 1:      # decode: one masked softmax over the cache
        out = decode_attention(q, kc, vc, cache_len, scale=scale)
    else:
        out = blockwise_attention(q, kc, vc, causal=True,
                                  q_offset=cache_len, block=cfg.attn_block,
                                  scale=scale)
    return out.reshape(B, S, h * hd) @ p["wo"], {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# attention on a mesh
# ---------------------------------------------------------------------------


def attn_replicated(cfg: ModelConfig, M: int) -> bool:
    """Whether attention runs whole on every rank of a model axis of
    ``M``: its Q heads do not split ``M`` ways, or a rank's block of them
    would not group evenly over the KV heads.  The reference's
    ``constrain`` replicates such heads; so do the parameters'
    placements (``train_step.leaf_placement``)."""
    H, KV = cfg.num_heads, cfg.kv_heads
    if M <= 1:
        return False
    if H % M:
        return True
    if KV % M == 0:
        return False
    g, hl = H // KV, H // M
    return bool(hl % g and g % hl)


def kv_heads_of_rank(cfg: ModelConfig, R) -> tuple:
    """(kv0, kv1, split): the KV heads this model rank's Q heads read, and
    whether the KV heads are split over ``model`` (else every rank
    computes all of them).  Only for heads that split
    (``attn_replicated`` false)."""
    H, KV = cfg.num_heads, cfg.kv_heads
    if R.split(KV):
        k = KV // R.M
        return R.m * k, (R.m + 1) * k, True
    g, hl = H // KV, H // R.M
    return (R.m * hl) // g, ((R.m + 1) * hl - 1) // g + 1, False


def whole_columns(w: torch.Tensor, n: int, R) -> torch.Tensor:
    """A weight whose last dimension (``n`` whole) the product needs whole
    on every rank: gathered over ``model`` when its placement splits it
    (backward: a rank's block, the gradient being whole on every rank)."""
    if R.split(n) and w.shape[-1] != n:
        return coll.gather_from(w, R.model_group, R.M, R.m, w.ndim - 1)
    return w


def project_kv(cfg: ModelConfig, R, x, w, b, kv: tuple, xc=None):
    """K (or V) of the KV heads ``kv`` = (kv0, kv1, split) from input
    ``x`` (B, S, ·): column-parallel on a split rank (from ``xc``,
    ``col_in(x)``); else every KV head (returned second, for a cache that
    holds them all) from the whole weight, the local heads then read
    through ``copy_to`` (their gradient is partial on each rank)."""
    B, S = x.shape[:2]
    kv0, kv1, split = kv
    hd = cfg.hdim
    if split:
        xc = col_in(x, R.model_group) if xc is None else xc
        t = col_mm(xc, w, x.dtype)
        if b is not None:
            t = t + coll.scatter_to(b, R.model_group, R.M, R.m, 0)
        return t.reshape(B, S, kv1 - kv0, hd), None
    t = x @ whole_columns(w, cfg.kv_heads * hd, R)
    if b is not None:
        t = t + b
    t = t.reshape(B, S, cfg.kv_heads, hd)
    return t, t


def _take_heads(t, kv, R):
    kv0, kv1, split = kv
    return t if split else coll.copy_to(t, R.model_group)[:, :, kv0:kv1]


def _write_rows(c, new, cache_len, offset: int):
    """Write ``new`` (B, S, ...) into cache block ``c`` (B, S_loc, ...)
    whose first row is sequence position ``offset``: rows outside the
    block are dropped.  ``cache_len``: an int (rows from there) or a (B,)
    tensor (one row a slot, S == 1)."""
    S_loc = c.shape[1]
    if isinstance(cache_len, torch.Tensor) and cache_len.ndim:
        rows = torch.arange(c.shape[0], device=c.device)
        local = cache_len - offset
        mine = (local >= 0) & (local < S_loc)
        idx = torch.where(mine, local, torch.zeros_like(local))
        old = c[rows, idx]
        c[rows, idx] = torch.where(mine.reshape(-1, *([1] * (new.ndim - 2))),
                                   new[:, 0].to(c.dtype), old)
        return
    lo = max(int(cache_len), offset)
    hi = min(int(cache_len) + new.shape[1], offset + S_loc)
    if lo < hi:
        c[:, lo - offset:hi - offset] = new[:, lo - int(cache_len):
                                            hi - int(cache_len)]


def _from_zero(cache_len) -> bool:
    """Whether a prefill starts at position 0 (its own K/V are then its
    whole prefix)."""
    return not isinstance(cache_len, torch.Tensor) and int(cache_len) == 0


def _write_seq_split(kc, vc, k, v, cache_len, R) -> int:
    """Write every KV head's new K/V rows into this rank's block of a
    cache whose sequence is split over ``model`` (blocks of ⌈L / model⌉,
    rows outside the block dropped); returns the block's first
    position."""
    offset = R.m * kc.shape[1]
    _write_rows(kc, k, cache_len, offset)
    _write_rows(vc, v, cache_len, offset)
    return offset


def decode_attention_seq(q, k, v, kv_len, offset: int, R):
    """Attention of S queries over a cache whose sequence is split over
    ``model`` (this rank holds positions [offset, offset + S_loc)), for
    ALL Q heads: query i sits at position ``kv_len + i`` and reads the
    keys at positions up to its own; each rank's partial maximum, sum and
    output, then the maximum and the two sums all-reduced
    (flash-decoding).  q: (B, S, H, D), k / v: (B, S_loc, KV, D);
    ``kv_len`` an int, or with S == 1 a (B,) tensor (each slot's
    position)."""
    B, S, H, D = q.shape
    S_loc, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * (1.0 / math.sqrt(D))
    kpos = offset + torch.arange(S_loc, device=q.device)
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1).expand(B)
    qpos = kv_len[:, None] + torch.arange(S, device=q.device)    # (B, S)
    mask = kpos[None, None, :] > qpos[:, :, None]                # (B, S, S_loc)
    s = s.masked_fill(mask[:, None, None], -1e30)
    m = coll.all_reduce_max(s.amax(dim=-1, keepdim=True), R.model_group)
    p = torch.exp(s - m)
    l_o = torch.cat([p.sum(dim=-1, keepdim=True),
                     torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype),
                                  v).float()], dim=-1)
    l_o = coll.all_reduce_sum(l_o, R.model_group)
    out = (l_o[..., 1:] / l_o[..., :1]).to(v.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def _attn_tp(cfg: ModelConfig, p: dict, x, positions, R, *, kv_cache=None,
             cache_len=None, kv_override=None, causal=True):
    """``attn_forward`` on a mesh: this rank's Q heads (``kv_override``:
    already this rank's KV heads); the output projection row-parallel,
    one all-reduce over ``model``."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.hdim
    g = R.model_group
    kv = kv_heads_of_rank(cfg, R)
    hl = H // R.M
    xc = col_in(x, g)
    q = col_mm(xc, p["wq"], x.dtype)
    if cfg.qkv_bias:
        q = q + coll.scatter_to(p["bq"], g, R.M, R.m, 0)
    q = q.reshape(B, S, hl, hd)
    full_q = (None, S, H, None)
    if kv_override is not None:
        k, v = kv_override
        q = sh.shard(q, "batch", "seq", "heads", None, full=full_q)
        out = blockwise_attention(q, k, v, causal=False, block=cfg.attn_block)
        return row_out(out.reshape(B, S, hl * hd), p["wo"], g), None
    k, k_all = project_kv(cfg, R, x, p["wk"],
                          p["bk"] if cfg.qkv_bias else None, kv, xc)
    v, v_all = project_kv(cfg, R, x, p["wv"],
                          p["bv"] if cfg.qkv_bias else None, kv, xc)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if k_all is not None:
        k_all = rope(k_all, positions, cfg.rope_theta)
        k = _take_heads(k_all, kv, R)
        v = _take_heads(v_all, kv, R)
    full_kv = (None, S, cfg.kv_heads, None)
    q = sh.shard(q, "batch", "seq", "heads", None, full=full_q)
    # the reference's constraints: split KV heads, or (not dividing) whole
    sh.shard(k if kv[2] else k_all, "batch", "seq", "kv_heads", None,
             full=full_kv)
    sh.shard(v if kv[2] else v_all, "batch", "seq", "kv_heads", None,
             full=full_kv)
    if kv_cache is None:
        out = blockwise_attention(q, k, v, causal=causal,
                                  block=cfg.attn_block)
    elif kv[2]:
        kc, vc = kv_cache["k"], kv_cache["v"]
        _write_rows(kc, k, cache_len, 0)
        _write_rows(vc, v, cache_len, 0)
        out = (decode_attention(q, kc, vc, cache_len) if S == 1 else
               blockwise_attention(q, kc, vc, causal=True,
                                   q_offset=cache_len, block=cfg.attn_block))
    else:
        # KV heads that do not split: the cache holds every KV head and a
        # block of the sequence
        kc, vc = kv_cache["k"], kv_cache["v"]
        offset = _write_seq_split(kc, vc, k_all, v_all, cache_len, R)
        if S > 1 and _from_zero(cache_len):
            out = blockwise_attention(q, k, v, causal=True,
                                      block=cfg.attn_block)
        else:       # every rank's partials are of every Q head
            q_all = coll.gather_cat(q, g, R.M, 2)
            out = decode_attention_seq(q_all, kc, vc, cache_len, offset,
                                       R)[:, :, R.m * hl:(R.m + 1) * hl]
    out = sh.shard(out, "batch", "seq", "heads", None, full=full_q)
    return row_out(out.reshape(B, S, hl * hd), p["wo"], g), kv_cache
