from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92544,
)  # GQA [arXiv:2403.17297]

_SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=512, attn_block=32, remat=False)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
