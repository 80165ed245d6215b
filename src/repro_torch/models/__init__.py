"""Model substrate of the port: ``ModelConfig`` and the layers
(``models/common.py``), the dense family (``models/transformer.py``)."""
from repro_torch.models.common import ModelConfig

__all__ = ["ModelConfig"]
