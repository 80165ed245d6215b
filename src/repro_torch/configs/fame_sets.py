"""The paper's MM benchmark grid (Table III) and the CPU-runnable
verification twins of its HE parameter sets — counterpart of
``repro/configs/fame_sets.py`` (the accelerator configurations of Table IV
are not ported yet; the sets themselves live in ``core/params.py``)."""
from __future__ import annotations

from repro_torch.core.params import toy_params

MM_BENCHMARKS = {
    "set-a": {"type-i": (64, 64, 16), "type-ii": (64, 16, 64),
              "type-iii": (16, 64, 64), "type-iv": (64, 64, 64)},
    "set-b": {"type-i": (128, 128, 16), "type-ii": (128, 16, 128),
              "type-iii": (16, 128, 128), "type-iv": (128, 128, 128)},
    "set-c": {"type-i": (160, 160, 16), "type-ii": (160, 16, 160),
              "type-iii": (16, 160, 160), "type-iv": (160, 160, 160)},
}

FAME_VERIFY_SETS = {
    "fame-s-rt": toy_params(logN=6, L=4, k=3, beta=2, scale_bits=26,
                            name="fame-s-rt"),
    "fame-m-rt": toy_params(logN=7, L=5, k=2, beta=3, scale_bits=26,
                            name="fame-m-rt"),
}
