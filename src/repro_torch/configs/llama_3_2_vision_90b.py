from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    cross_attn_period=5, frontend_tokens=1601, frontend_dim=8192,
)  # cross-attn image layers every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision]

_SMOKE = dict(num_layers=10, cross_attn_period=5, d_model=64, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=512, frontend_tokens=8,
              frontend_dim=64, attn_block=32, remat=False)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
