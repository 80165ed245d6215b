"""Model configuration — counterpart of ``repro/models/common.py``.

Only ``ModelConfig`` is ported so far: the secure-serving tier
(``serve/engine.py`` ``build_secure_serving``) reads ``secure_layers``
from it.  The layers themselves (norms, RoPE, attention, MLPs,
embeddings) and the model zoo come with ROADMAP queue 1 item 10, the
non-HE stack.
"""
from __future__ import annotations

import dataclasses

import torch


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
