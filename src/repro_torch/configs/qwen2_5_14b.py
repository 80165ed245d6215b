from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, qkv_bias=True,
)  # GQA, QKV bias [hf:Qwen/Qwen2.5]

_SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=512, attn_block=32, remat=False)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
