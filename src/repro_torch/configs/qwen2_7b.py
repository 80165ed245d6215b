from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True,
)  # GQA kv=4, QKV bias [arXiv:2407.10671]

_SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=512, attn_block=32, remat=False)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
