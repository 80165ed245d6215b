"""Fault tolerance and straggler detection — counterpart of
``repro/distributed/fault.py``.

The control plane of a training fleet (heartbeats, a step deadline,
checkpoint-restart) written so tests can drive it on the CPU: failures
are injected through ``HeartbeatTracker`` / a step's fail hook, and
recovery goes through the port's ``checkpoint.restore``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint import checkpoint as ckpt


@dataclasses.dataclass
class FaultConfig:
    heartbeat_timeout_s: float = 60.0
    step_deadline_factor: float = 3.0     # straggler: step > factor × EMA
    ckpt_every_steps: int = 100
    max_restarts: int = 100


class HeartbeatTracker:
    """Per-host liveness: hosts call ``beat``; a host silent for longer
    than ``heartbeat_timeout_s`` is dead.  Tests withhold beats to
    simulate failures."""

    def __init__(self, num_hosts: int, cfg: FaultConfig, clock=time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.last = {h: clock() for h in range(num_hosts)}

    def beat(self, host: int):
        self.last[host] = self.clock()

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        return [h for h, t in self.last.items()
                if now - t > self.cfg.heartbeat_timeout_s]


class StragglerDetector:
    """EMA of step time; flags steps exceeding deadline_factor × EMA (a
    flagged step does not move the EMA)."""

    alpha = 0.9                 # the EMA's weight on its past

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.ema_t: Optional[float] = None
        self.flagged = 0

    def observe(self, step_time: float) -> bool:
        is_straggler = (self.ema_t is not None
                        and step_time > self.cfg.step_deadline_factor * self.ema_t)
        if is_straggler:
            self.flagged += 1
        else:
            self.ema_t = (step_time if self.ema_t is None
                          else self.alpha * self.ema_t
                          + (1 - self.alpha) * step_time)
        return is_straggler


class ElasticRunner:
    """Checkpoint-restart training loop with injected-failure support.

    ``run`` executes ``step_fn(state, batch) -> (state, metrics)`` until
    ``total_steps``, checkpointing every ``ckpt_every_steps`` and at the
    end; when ``fail_hook`` raises ``SimulatedFailure``, the runner
    restores the latest checkpoint into ``state_template_fn()`` and
    continues from its step.

    On a mesh, ``shardings`` is the state's placements (a save gathers
    the state and rank 0 writes; a restore keeps a rank's blocks) and
    ``remesh_fn``, called after a failure and before the restore, may
    install another mesh's rules and returns the state's placements on
    it (None: keep the current ones); the template is then the whole
    state's shapes (``abstract_train_state``)."""

    def __init__(self, ckpt_dir: str, cfg: FaultConfig, step_fn, batch_fn,
                 state_template_fn: Callable[[], object],
                 remesh_fn: Optional[Callable[[], object]] = None,
                 shardings=None):
        self.ckpt_dir = ckpt_dir
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.state_template_fn = state_template_fn
        self.remesh_fn = remesh_fn
        self.shardings = shardings
        self.restarts = 0

    def run(self, state, total_steps: int,
            fail_hook: Optional[Callable[[int], None]] = None):
        step = 0
        detector = StragglerDetector(self.cfg)
        while step < total_steps:
            try:
                t0 = time.monotonic()
                if fail_hook is not None:
                    fail_hook(step)
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                detector.observe(time.monotonic() - t0)
                step += 1
                if step % self.cfg.ckpt_every_steps == 0 or step == total_steps:
                    ckpt.save(self.ckpt_dir, step, state,
                              extra={"metrics": {k: float(v) for k, v
                                                 in metrics.items()}},
                              shardings=self.shardings)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                if self.remesh_fn is not None:
                    shardings = self.remesh_fn()
                    if shardings is not None:
                        self.shardings = shardings
                last = ckpt.latest_step(self.ckpt_dir)
                if last is None:
                    step = 0
                    continue
                state, meta = ckpt.restore(self.ckpt_dir,
                                           self.state_template_fn(),
                                           shardings=self.shardings)
                step = meta["step"]
        return state, step


class SimulatedFailure(RuntimeError):
    pass
