from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_period=6,
)  # Mamba2 backbone + shared attention blocks [arXiv:2411.15242]

_SMOKE = dict(num_layers=6, attn_period=3, d_model=64, num_heads=4,
              num_kv_heads=4, d_ff=128, vocab_size=512, ssm_state=16,
              ssm_head_dim=16, ssm_chunk=16, attn_block=32, remat=False,
              dtype="float32")  # f32 smoke: chunked-SSD vs recurrence equality


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
