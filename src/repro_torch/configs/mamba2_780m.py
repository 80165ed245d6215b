from repro_torch.models.common import ModelConfig
import dataclasses

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=24, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, conv_kernel=4,
    tie_embeddings=True,
)  # SSD (state-space duality) [arXiv:2405.21060]

_SMOKE = dict(num_layers=2, d_model=64, vocab_size=512, ssm_state=16,
              ssm_head_dim=16, ssm_chunk=16, remat=False)


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        CONFIG,
        name=CONFIG.name + "-smoke",
        **_SMOKE)
