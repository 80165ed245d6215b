"""Serving launcher: continuous batching over a model of the registry —
counterpart of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --requests 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --smoke --tp 2 --device cpu          # 2 spawned gloo ranks

Weights are random, drawn from a generator seeded with 0 on the device
(the reference draws ``init_params(cfg, PRNGKey(0))``); prompts are 8
tokens from ``numpy.random.default_rng(0)``.  Runs on CUDA unless
``--device`` says otherwise.  ``--tp N`` serves on a (data 1 × model N)
mesh, as the reference's launcher: inside a process group ``torchrun``
started (N ranks), or on N ranks it spawns on this host (``launch/
mesh.py``), over ``--backend`` (default: NCCL on CUDA, gloo on the CPU;
ranks that share one card need gloo).  Every rank runs the batcher and
samples the same tokens.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.ckks import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ContinuousBatcher, ServeConfig


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend of a --tp mesh "
                         "(default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    return ap.parse_args(argv)


def _serve(args, dev) -> ContinuousBatcher:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
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
    if sh.ranks() is None or sh.ranks().mesh.rank == 0:
        print(f"[serve] {args.requests} requests, {steps} decode steps")
    return batcher


def _on_mesh(args, dev) -> ContinuousBatcher:
    """This rank's run on the (1, tp) mesh of the process group."""
    mesh = mesh_mod.make_mesh_for(args.tp, model_parallel=args.tp,
                                  device=dev, backend=args.backend)
    prev = sh.get_rules()
    sh.set_rules(sh.make_rules(mesh))
    try:
        return _serve(args, mesh.device)
    finally:
        sh.set_rules(prev)


def _rank(argv) -> ContinuousBatcher:
    """A spawned rank: its batcher, its tensors released (the results and
    the slots are what the caller reads)."""
    args = _parse(argv)
    b = _on_mesh(args, resolve_device(args.device))
    b.params = b.cache = None
    return b


def main(argv=None) -> ContinuousBatcher:
    """Serve ``--requests`` prompts to completion; returns the batcher (on
    spawned ranks, rank 0's with its tensors released)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    dev = resolve_device(args.device)
    if args.tp == 1:
        return _serve(args, dev)
    if mesh_mod.init_from_env(dev, args.backend):
        return _on_mesh(args, dev)
    return mesh_mod.spawn(_rank, args.tp, argv, device=dev,
                          backend=args.backend)[0]


if __name__ == "__main__":
    main()
