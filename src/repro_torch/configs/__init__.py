"""Configurations of the port: the FAME parameter sets (``fame_sets``) and
the model registry (``registry`` and one module an architecture)."""
from repro_torch.configs.registry import (ARCHS, SHAPES, all_cells,
                                          cells_for, get_config,
                                          get_smoke_config)

__all__ = ["ARCHS", "SHAPES", "cells_for", "get_config", "get_smoke_config",
           "all_cells"]
