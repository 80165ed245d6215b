"""Training launcher: train step + data + checkpoints + straggler
detection — counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 6 --global-batch 4 --seq 512

Weights are random, drawn from a generator seeded with 0 on the device
(the reference draws ``init_train_state(cfg, tcfg, PRNGKey(0))``); the
batches are ``synth_batch``'s.  A checkpoint in ``--ckpt-dir`` is resumed
from (the step-keyed data stream resumes with it).  Runs on CUDA unless
``--device`` says otherwise.

``--dp D --tp M`` trains on a (data D × model M) mesh, as the
reference's launcher: inside a process group ``torchrun`` started (D·M
ranks), or on D·M ranks it spawns on this host (``launch/mesh.py``),
over ``--backend`` (default: NCCL on CUDA, gloo on the CPU; ranks that
share one card need gloo).  Each rank holds its blocks of the state
(``train_step.param_shardings``) and reads its rows of every batch (the
pipeline's host index and count are the rank's data index and the data
ranks); checkpoints hold the whole state and resume onto any mesh.
``--production-mesh`` is the 16 × 16 mesh, ``--multi-pod`` the 2 × 16 ×
16 one (the reference reads ``--multi-pod`` only beside
``--production-mesh``); both need a process group of that many ranks
(``torchrun``) and raise, naming the count, without one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --steps 4 --dp 2 --tp 2 --device cpu   # 4 spawned ranks
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.ckks import resolve_device
from repro_torch.data.pipeline import (DataConfig, PrefetchLoader, device_batch,
                                      synth_batch)
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.fault import FaultConfig, StragglerDetector
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.common import ModelConfig
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, abstract_train_state,
                                          init_train_state,
                                          make_sharded_train_step,
                                          param_shardings, train_step)


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


def _parse(argv):
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
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend of a mesh (default: "
                         "nccl on cuda, gloo on cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    return ap.parse_args(argv)


def _train(args, dev, mesh=None) -> TrainRun:
    """The loop on one device, or on this rank of ``mesh`` (whose rules
    are installed)."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        opt=OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                      compress_grads=args.compress_grads))
    R = sh.ranks()
    dcfg = DataConfig(global_batch=args.global_batch, seq_len=args.seq,
                      num_hosts=1 if R is None else R.D,
                      host_id=0 if R is None else R.d)
    lead = R is None or R.mesh.rank == 0

    state = init_train_state(cfg, tcfg,
                             torch.Generator(device=dev).manual_seed(0))
    st_sh = None
    step_fn = functools.partial(train_step, cfg, tcfg)
    if mesh is not None:
        st_sh = param_shardings(cfg, abstract_train_state(cfg, tcfg),
                                sh.get_rules())
        first = device_batch(cfg, synth_batch(cfg, dcfg, 0), dev)
        step_fn = make_sharded_train_step(cfg, tcfg, mesh, state, first)
    start = 0
    if ckpt.latest_step(args.ckpt_dir) is not None:
        if mesh is None:
            state, meta = ckpt.restore(args.ckpt_dir, state)
        else:
            state, meta = ckpt.restore(args.ckpt_dir,
                                       abstract_train_state(cfg, tcfg),
                                       shardings=st_sh)
        start = meta["step"]
        if lead:
            print(f"[train] elastic resume from step {start}")
    loader = PrefetchLoader(cfg, dcfg, start_step=start)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir, shardings=st_sh)
    straggle = StragglerDetector(FaultConfig())
    history = []
    try:
        for step, batch in loader:
            if step >= args.steps:
                break
            t0 = time.time()
            state, metrics = step_fn(state, device_batch(cfg, batch, dev))
            straggle.observe(time.time() - t0)
            history.append(metrics)
            if step % 10 == 0 and lead:
                print(f"[train] step {step} loss {float(metrics['loss']):.4f}")
            if (step + 1) % args.ckpt_every == 0:
                saver.save(step + 1, state)
    finally:
        loader.close()
        saver.wait()
    if lead:
        print(f"[train] finished at step {args.steps}; "
              f"stragglers={straggle.flagged}")
    return TrainRun(cfg, tcfg, start, state, history)


def _on_mesh(args, dev) -> TrainRun:
    """This rank's run on the mesh of the initialized process group."""
    if args.production_mesh or args.multi_pod:
        mesh = mesh_mod.make_production_mesh(multi_pod=args.multi_pod,
                                             device=dev, backend=args.backend)
    else:
        mesh = mesh_mod.make_mesh_for(args.dp * args.tp,
                                      model_parallel=args.tp, device=dev,
                                      backend=args.backend)
    prev = sh.get_rules()
    sh.set_rules(sh.make_rules(mesh))
    try:
        return _train(args, mesh.device, mesh)
    finally:
        sh.set_rules(prev)


def _rank(argv) -> TrainRun:
    """A spawned rank's run."""
    args = _parse(argv)
    return _on_mesh(args, resolve_device(args.device))


def main(argv=None) -> TrainRun:
    """Train ``--steps`` steps; returns the run (on spawned ranks, rank
    0's: its blocks of the state, the global metrics)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    dev = resolve_device(args.device)
    production = args.production_mesh or args.multi_pod
    if args.dp * args.tp == 1 and not production:
        return _train(args, dev)
    if mesh_mod.init_from_env(dev, args.backend) or production:
        return _on_mesh(args, dev)
    return mesh_mod.spawn(_rank, args.dp * args.tp, argv, device=dev,
                          backend=args.backend)[0]


if __name__ == "__main__":
    main()
