"""Shared pieces of the benchmark's tests: the toy cell and a chip check."""
import json
import pathlib
import shutil

import pytest
import torch

TOY_FILES = pathlib.Path(__file__).resolve().parent / "toy"
TOY_CELL = "toy-hemm"
ROOT = TOY_FILES.parents[2]


def make_toy(dest: pathlib.Path) -> pathlib.Path:
    """A root for the toy cell in ``dest``: the files of ``tests/toy`` and
    a ``BENCHMARK.json`` of the toy's configuration and cell
    (``toy/cell.json``) with the metrics of the repo's ``BENCHMARK.json``,
    each listed for the toy cell where it lists cells."""
    shutil.copytree(TOY_FILES, dest, dirs_exist_ok=True)
    spec = json.loads((TOY_FILES / "cell.json").read_text())
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    toy = lambda m: dict(m, workloads=[TOY_CELL]) if "workloads" in m else m
    for group in ("end_to_end", "per_layer"):
        spec[group] = [toy(m) for m in real[group]]
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return dest


def need_chip():
    """Skip the calling test unless a CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
