"""granite-4.0-h-small (IBM Granite 4.0-H Small, 32B-A9B): 40 layers, 36
Mamba-2 and 4 NoPE GQA attention layers (at 5, 15, 25, 35), each followed
by 72 routed SwiGLU experts (top-10) and a shared SwiGLU expert
[hf:ibm-granite/granite-4.0-h-small config.json].

``d_ff`` is one routed expert's width: the config's ``intermediate_size``
(768) read as that width, an inference (the config has no key of its own
for it).  The serving path drops no token: ``capacity_factor`` is
E/k = 7.2, so an expert's capacity ⌈g·k/E·7.2⌉ ≥ g holds every token of a
dispatch group of g (a token takes an expert at most once).
"""
import dataclasses

from repro_torch.models.common import HybridMoEConfig

#: one period of the published ``layer_types``: attention at offset 5
PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small", family="hybrid_moe",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=768, vocab_size=100352, num_experts=72, experts_per_token=10,
    capacity_factor=7.2,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, conv_kernel=4,
    ssm_chunk=256, norm_eps=1e-5, tie_embeddings=True,
    layer_pattern=PERIOD, shared_ff=1536, position_embedding="nope",
    attention_multiplier=0.0078125, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0,
)

_SMOKE = dict(num_layers=10, d_model=32, num_heads=4, num_kv_heads=2,
              head_dim=8, d_ff=16, shared_ff=24, vocab_size=128,
              num_experts=8, experts_per_token=2, capacity_factor=4.0,
              ssm_state=16, ssm_head_dim=8, ssm_chunk=8, attn_block=16,
              attention_multiplier=0.25, remat=False, dtype="float32")


def smoke_config() -> HybridMoEConfig:
    """Reduced same-family config for CPU tests: one period, the shared
    expert, NoPE, the multipliers, top-2 of 8 experts at E/k (dropless),
    float32."""
    return dataclasses.replace(CONFIG, name=CONFIG.name + "-smoke", **_SMOKE)
