"""Architecture/config registry + assigned input shapes — counterpart of
``repro/configs/registry.py``.

Each assigned arch has its own module (``repro_torch/configs/<id>.py``,
data only, field for field the reference's) exporting CONFIG (full size)
and smoke_config() (reduced, CPU-runnable).  Only the dense family runs
in the port so far (``models/transformer.py``).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "mamba2-780m",
    "grok-1-314b",
    "granite-moe-3b-a800m",
    "llama-3.2-vision-90b",
    "internlm2-1.8b",
    "qwen2.5-14b",
    "nemotron-4-340b",
    "qwen2-7b",
    "musicgen-large",
    "zamba2-2.7b",
]

# shape name -> (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": dict(seq=4096, batch=256, step="train"),
    "prefill_32k": dict(seq=32768, batch=32, step="prefill"),
    "decode_32k": dict(seq=32768, batch=128, step="decode"),
    "long_500k": dict(seq=524288, batch=1, step="decode"),
}

# long_500k needs sub-quadratic attention: SSM/hybrid only (DESIGN.md §4).
SUBQUADRATIC = {"mamba2-780m", "zamba2-2.7b"}


def _mod(name: str):
    return importlib.import_module("repro_torch.configs." + name.replace("-", "_")
                                   .replace(".", "_"))


def get_config(name: str):
    return _mod(name).CONFIG


def get_smoke_config(name: str):
    return _mod(name).smoke_config()


def cells_for(arch: str) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        out.append("long_500k")
    return out


def all_cells() -> list[tuple[str, str]]:
    """The assigned 40-cell grid: every arch × its 4 shapes. For pure
    full-attention archs the long_500k slot is replaced by nothing and the
    grid lists their 3 applicable shapes + documented skip — but the
    assignment pairs each arch with 4 shapes, so non-subquadratic archs keep
    (train, prefill, decode) plus long_500k marked skipped at dry-run time."""
    cells = []
    for a in ARCHS:
        for s in ["train_4k", "prefill_32k", "decode_32k", "long_500k"]:
            cells.append((a, s))
    return cells


def cell_enabled(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True
