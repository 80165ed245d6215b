"""Checkpoint/restart for fault tolerance — counterpart of
``repro/checkpoint/checkpoint.py``, in its on-disk format.

``step_N/state.npz`` holds every leaf as its full array under the
reference's pytree path, keys joined with ``§`` (bfloat16 widened to
float32, exactly), beside ``step_N/meta.json``.  The port keeps a model's
blocks as a list (``params["layers"][b]``) where the reference stacks
them on a leading axis: a save stacks the blocks back onto that axis and
a restore splits it, so the key set is the reference's and a checkpoint
either package writes restores in the other.  Atomic rename, retained
history, and an async writer that blocks the loop only for the copy to
the host.

On a mesh (``shardings``: the state's placements,
``train_step.param_shardings``) a save gathers every leaf whole
(``Placement.gather``, on every rank) and rank 0 writes the reference's
file; a restore reads the whole arrays and keeps a rank's blocks, so a
checkpoint written on one mesh restores on another (elastic resume).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import (leaves, leaves_with_paths, reference_path,
                              tree_map, unflatten)

SEP = "§"


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:     # npz can't round-trip bf16
            leaf = leaf.float()              # exact upcast
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    flat, blocks = {}, {}
    for path, leaf in leaves_with_paths(tree):
        ref, b = reference_path(path)
        key = SEP.join(str(k) for k in ref)
        if b is None:
            flat[key] = _numpy(leaf)
        else:
            blocks.setdefault(key, []).append(_numpy(leaf))
    for key, parts in blocks.items():        # blocks come in index order
        flat[key] = np.stack(parts)
    return flat


def _unflatten_into(template, flat: dict):
    out = []
    for path, leaf in leaves_with_paths(template):
        ref, b = reference_path(path)
        key = SEP.join(str(k) for k in ref)
        arr = flat[key] if b is None else flat[key][b]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint {arr.shape}, template "
                             f"{tuple(leaf.shape)}")
        dev = "cpu" if leaf.device.type == "meta" else leaf.device
        out.append(torch.as_tensor(arr).to(device=dev, dtype=leaf.dtype))
    return unflatten(template, out)


def gather_state(state, shardings):
    """Every leaf of a rank's ``state`` whole (``shardings`` None: the
    state itself)."""
    if shardings is None:
        return state
    return unflatten(state, [pl.gather(t) for t, pl in
                             zip(leaves(state), leaves(shardings),
                                 strict=True)])


def _rank0(shardings) -> bool:
    if shardings is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def save(ckpt_dir: str, step: int, state, extra: Optional[dict] = None,
         keep: int = 3, shardings=None) -> str:
    """Atomic checkpoint write; prunes to the newest `keep` checkpoints.
    On a mesh (``shardings``) every rank calls it: the state is gathered
    whole, rank 0 writes, and every rank returns once the file is
    there."""
    if shardings is not None:
        from repro_torch.distributed import collectives
        whole = gather_state(state, shardings)
        path = save(ckpt_dir, step, whole, extra, keep) if _rank0(
            shardings) else os.path.join(ckpt_dir, f"step_{step}")
        collectives.barrier()
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "state.npz"), **_flatten(state))
    meta = {"step": step, "time": time.time(), **(extra or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, state_template, step: Optional[int] = None,
            shardings=None):
    """Load checkpoint ``step`` (default: the latest) into the structure,
    shapes, dtypes and devices of ``state_template`` (tensors, or ``meta``
    tensors from ``abstract_train_state``, whose leaves land on the CPU).
    With ``shardings`` (the placements on the current mesh) the template
    holds whole shapes and a rank keeps its blocks, on the mesh's device
    (elastic resume onto another mesh).  Returns (state, meta)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(path, "state.npz")) as z:
        flat = {k: z[k] for k in z.files}
    state = _unflatten_into(state_template, flat)
    if shardings is not None:
        state = unflatten(state, [
            pl.local(t).to(pl.mesh.device) for t, pl in
            zip(leaves(state), leaves(shardings), strict=True)])
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return state, meta


class AsyncCheckpointer:
    """Snapshot on the host, then write in a background thread, so the
    train loop waits only for the device-to-host copy, not the disk.
    ``wait`` joins the writer and raises what it raised."""

    def __init__(self, ckpt_dir: str, keep: int = 3, shardings=None):
        """``shardings``: the state's placements on a mesh (every rank
        saves; the leaves are gathered on the loop's thread and rank 0
        writes)."""
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.shardings = shardings
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, state, extra: Optional[dict] = None):
        self.wait()
        state = gather_state(state, self.shardings)
        if not _rank0(self.shardings):
            return
        # a copy even on the CPU: the train step updates the state in place
        host_state = tree_map(lambda t: t.detach().to("cpu", copy=True),
                              state)
        self._thread = threading.Thread(
            target=self._write, args=(step, host_state, extra), daemon=True)
        self._thread.start()

    def _write(self, step, host_state, extra):
        try:
            self.last_path = save(self.ckpt_dir, step, host_state, extra,
                                  keep=self.keep)
        except Exception as e:        # re-raised on the loop's thread
            self._error = e

    def wait(self):
        """Join the writer (on a mesh: every rank returns once rank 0's
        writer has)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.shardings is not None:
            from repro_torch.distributed import collectives
            collectives.barrier()
        if self._error is not None:
            error, self._error = self._error, None
            raise error
