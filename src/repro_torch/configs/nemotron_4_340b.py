from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, mlp="squared_relu",
)  # GQA, squared-ReLU MLP [arXiv:2402.16819]

_SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=512, attn_block=32, remat=False)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
