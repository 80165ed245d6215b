"""Training launcher: train step + data + checkpoints + straggler
detection — counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 6 --global-batch 4 --seq 512

Weights are random, drawn from a generator seeded with 0 on the device
(the reference draws ``init_train_state(cfg, tcfg, PRNGKey(0))``); the
batches are ``synth_batch``'s.  A checkpoint in ``--ckpt-dir`` is resumed
from (the step-keyed data stream resumes with it).  Runs on CUDA unless
``--device`` says otherwise.  One device only: ``--dp`` / ``--tp`` other
than 1, ``--production-mesh`` and ``--multi-pod`` (the reference's mesh)
wait for the LM half of the multi-device schedule.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.ckks import resolve_device
from repro_torch.data.pipeline import DataConfig, PrefetchLoader, device_batch
from repro_torch.distributed.fault import FaultConfig, StragglerDetector
from repro_torch.models.common import ModelConfig
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          train_step)


@dataclasses.dataclass
class TrainRun:
    """What ``main`` ran: the configs, the first step taken (the resumed
    checkpoint's, else 0), the final state and each step's metrics (0-d
    tensors, in step order)."""
    cfg: ModelConfig
    tcfg: TrainConfig
    start: int
    state: dict
    metrics: list


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 (or 2x16x16) production mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    if (args.dp, args.tp) != (1, 1) or args.production_mesh or args.multi_pod:
        raise NotImplementedError(
            "--dp / --tp / --production-mesh / --multi-pod: the LM's device "
            "mesh (the LM half of the multi-device schedule) is not ported "
            "yet")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        opt=OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                      compress_grads=args.compress_grads))
    dcfg = DataConfig(global_batch=args.global_batch, seq_len=args.seq)

    state = init_train_state(cfg, tcfg,
                             torch.Generator(device=dev).manual_seed(0))
    start = 0
    if ckpt.latest_step(args.ckpt_dir) is not None:
        state, meta = ckpt.restore(args.ckpt_dir, state)
        start = meta["step"]
        print(f"[train] elastic resume from step {start}")
    loader = PrefetchLoader(cfg, dcfg, start_step=start)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
    straggle = StragglerDetector(FaultConfig())
    history = []
    try:
        for step, batch in loader:
            if step >= args.steps:
                break
            t0 = time.time()
            state, metrics = train_step(cfg, tcfg, state,
                                        device_batch(cfg, batch, dev))
            straggle.observe(time.time() - t0)
            history.append(metrics)
            if step % 10 == 0:
                print(f"[train] step {step} loss {float(metrics['loss']):.4f}")
            if (step + 1) % args.ckpt_every == 0:
                saver.save(step + 1, state)
    finally:
        loader.close()
        saver.wait()
    print(f"[train] finished at step {args.steps}; "
          f"stragglers={straggle.flagged}")
    return TrainRun(cfg, tcfg, start, state, history)


if __name__ == "__main__":
    main()
