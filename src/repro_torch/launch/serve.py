"""Serving launcher: continuous batching over a model of the registry —
counterpart of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --requests 4 --device cpu

Weights are random, drawn from a generator seeded with 0 on the device
(the reference draws ``init_params(cfg, PRNGKey(0))``); prompts are 8
tokens from ``numpy.random.default_rng(0)``.  Runs on CUDA unless
``--device`` says otherwise.  One device only: ``--tp`` other than 1 (the
reference's tensor-parallel mesh) waits for the LM half of the
multi-device schedule.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.ckks import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ContinuousBatcher, ServeConfig


def main(argv=None) -> ContinuousBatcher:
    """Serve ``--requests`` prompts to completion; returns the batcher."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    if args.tp != 1:
        raise NotImplementedError(
            "--tp: the LM's tensor-parallel mesh (the LM half of the "
            "multi-device schedule) is not ported yet; the HE schedule runs "
            "on a mesh through HEContext(mesh=)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batcher = ContinuousBatcher(cfg, ServeConfig(max_batch=4, max_len=128),
                                params)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        batcher.submit(
            rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
            max_new=args.max_new)
    steps = 0
    while batcher.step():
        steps += 1
    print(f"[serve] {args.requests} requests, {steps} decode steps")
    return batcher


if __name__ == "__main__":
    main()
