"""Synthetic sharded token pipeline with background host prefetch —
counterpart of ``repro/data/pipeline.py``, the same numpy generator calls,
so every batch is array-equal to the reference's.

Deterministic per (seed, host, step): every host generates only its shard
of the global batch, and a restarted job with a different host count
resumes the same global sample stream (the checkpoint stores ``step``).
One host unless ``DataConfig`` says otherwise: on a mesh the training
launcher sets ``num_hosts`` / ``host_id`` to the ranks along the batch
axes (pod × data) and this rank's index there.  ``device_batch`` puts a
host batch on a device as tensors.  ``DataConfig`` leaves out the
reference's ``kind``, which nothing reads: the model's family sets the
batch's keys.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


def _host_slice(dcfg: DataConfig):
    per = dcfg.global_batch // dcfg.num_hosts
    return dcfg.host_id * per, per


def synth_batch(cfg: ModelConfig, dcfg: DataConfig, step: int) -> dict:
    """Markov-ish synthetic tokens (not uniform noise: loss can decrease):
    ``targets`` (per-host batch, seq_len) int32, and ``tokens`` — or, for
    the audio family, float32 frame ``embeds`` — plus the vlm's float32
    ``frontend``."""
    start, per = _host_slice(dcfg)
    out = {}
    toks = np.empty((per, dcfg.seq_len + 1), np.int32)
    for b in range(per):
        rng = np.random.default_rng(
            (dcfg.seed, step, start + b))          # sample-keyed: elastic-safe
        state = rng.integers(0, cfg.vocab_size)
        stride = 1 + (start + b) % 17
        seq = (state + stride * np.arange(dcfg.seq_len + 1)
               + rng.integers(0, 3, dcfg.seq_len + 1)) % cfg.vocab_size
        toks[b] = seq
    out["targets"] = toks[:, 1:]
    if cfg.family == "audio":
        rngf = np.random.default_rng((dcfg.seed, step, 10 ** 6))
        out["embeds"] = rngf.normal(
            size=(per, dcfg.seq_len, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = toks[:, :-1]
    if cfg.family == "vlm":
        rngf = np.random.default_rng((dcfg.seed, step, 10 ** 6 + 1))
        out["frontend"] = rngf.normal(
            size=(per, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)
        ).astype(np.float32)
    return out


def device_batch(cfg: ModelConfig, batch: dict, device) -> dict:
    """A host batch as tensors on ``device``: integer arrays (token ids,
    targets) as int64, float arrays (frame embeddings, the frontend) in
    the activation dtype, where the model casts them anyway."""
    def tensor(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        t = t.to(cfg.adtype) if t.is_floating_point() else t.long()
        return t.to(device)
    return {k: tensor(v) for k, v in batch.items()}


class PrefetchLoader:
    """Background-thread prefetch of synth batches (host-side pipelining)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0):
        self.cfg, self.dcfg = cfg, dcfg
        self._q: queue.Queue = queue.Queue(maxsize=dcfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, self.dcfg, step)
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
