"""The train step: value and grad of the model loss, gradient accumulation
over microbatches, the optimizer update — counterpart of
``repro/train/train_step.py``.

Grads come from ``torch.autograd.grad`` on detached aliases of the
parameters that require grad (``torch.func.grad`` does not compose with
``torch.utils.checkpoint``).  Microbatch grads are summed in float32, as
the reference's ``lax.scan`` carry is.  The state is updated in place
(``train/optimizer.py``).  One device only: the reference's
``make_sharded_train_step`` and ``param_shardings`` (its mesh layout)
wait for the multi-device schedule.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig
from repro_torch.train.optimizer import OptConfig, apply_updates, init_opt_state
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's, without ``rs_accumulate``: both of its branches
    are the same float32 sum."""
    microbatches: int = 1
    opt: OptConfig = OptConfig()


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     gen: torch.Generator) -> dict:
    """{"params", "opt"}: ``tf.init_params`` on ``gen``'s device and its
    optimizer state."""
    params = tf.init_params(cfg, gen)
    return {"params": params, "opt": init_opt_state(tcfg.opt, params)}


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """The train state's shapes and dtypes as ``meta`` tensors (nothing
    allocated): a template for ``checkpoint.restore``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        state = init_train_state(cfg, tcfg, torch.Generator())
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """Microbatch i holds rows [i·B/n, (i+1)·B/n) of every leaf."""
    return [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n)]


def value_and_grad(cfg: ModelConfig, params, batch):
    """((total, metrics), grads) of ``tf.train_loss``: ``jax.value_and_grad(
    ..., has_aux=True)``'s result, detached; grads a list in
    ``tree.leaves(params)`` order, each in its parameter's dtype (zeros
    where the loss does not reach the parameter)."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    total, metrics = tf.train_loss(cfg, unflatten(params, live), batch)
    grads = torch.autograd.grad(total, live, allow_unused=True,
                                materialize_grads=True)
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            list(grads))


def train_step(cfg: ModelConfig, tcfg: TrainConfig, state: dict, batch: dict):
    """One optimizer step on ``batch`` (leaves of leading size the global
    batch).  Returns (state, metrics): the train loss's metrics with one
    microbatch, else {"loss"} (the mean total), and the optimizer's."""
    params = state["params"]
    nmb = tcfg.microbatches
    if nmb == 1:
        (_, metrics), grads = value_and_grad(cfg, params, batch)
    else:
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves(params)]
        lsum = 0.0
        for mb in _split_microbatches(batch, nmb):
            (total, _), g = value_and_grad(cfg, params, mb)
            for acc, gi in zip(grads, g, strict=True):
                acc += gi
            lsum = lsum + total
        for acc in grads:
            acc /= nmb
        metrics = {"loss": lsum / nmb}
    params, opt, opt_metrics = apply_updates(
        tcfg.opt, params, unflatten(params, grads), state["opt"])
    return {"params": params, "opt": opt}, dict(metrics, **opt_metrics)
