"""Model substrate of the port: ``ModelConfig`` only (``models/common.py``);
the layers and the model zoo come with ROADMAP queue 1 item 10."""
from repro_torch.models.common import ModelConfig

__all__ = ["ModelConfig"]
