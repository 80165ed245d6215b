from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, num_experts=8, experts_per_token=2,
)  # 8 experts top-2 [hf:xai-org/grok-1]

_SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=512, num_experts=4, experts_per_token=2,
              attn_block=32, remat=False)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
