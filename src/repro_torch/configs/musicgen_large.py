from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, mlp="gelu",
)  # decoder-only over EnCodec tokens; frame-embedding frontend is a stub
   # [arXiv:2306.05284]

_SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
              d_ff=128, vocab_size=64, attn_block=32, remat=False)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
