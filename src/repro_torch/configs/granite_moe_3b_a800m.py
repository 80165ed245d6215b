from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, num_experts=40, experts_per_token=8,
)  # 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]

_SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=64, vocab_size=512, num_experts=8, experts_per_token=4, capacity_factor=8.0,
              attn_block=32, remat=False)  # dropless in smoke: serve==train path


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
