"""The training stack's numerics: the port's optimizer
(``repro_torch.train.optimizer``), ``train_loss`` and its gradients
(``repro_torch.models.transformer``) and ``train_step``
(``repro_torch.train.train_step``) against the reference's
(``repro.train``, ``repro.models.transformer``).

Tolerances, all float32:
- the optimizer on identical grads: ``rtol 1e-6`` (the int8 compression
  array-equal);
- ``train_loss`` for each of the six families' smoke configs (the MoE's
  is dropless) from the reference's state carried across by
  ``convert.train_state``: the loss and metrics within ``rtol 1e-5``,
  every gradient leaf within ``1e-4 · max|g|`` of the reference's
  ``jax.value_and_grad(train_loss, has_aux=True)``;
- one whole ``train_step`` (1 and 2 microbatches, and compressed grads):
  metrics within ``rtol 1e-5``; the new master weights and parameters
  within ``STEP_TOL`` (``rtol 1e-5``, ``atol`` 5 % of lr) where the
  reference gradient is at least ``1e-6 · max|g|`` of its leaf — Adam's
  first step moves the others by ±lr on the sign of a rounding-level
  gradient (the test prints how many it leaves out), and divides by
  |g| + eps, so just above that floor a gradient off by its float32
  rounding still moves an entry by a few % of lr; the moments within
  ``1e-4`` of their own max and the error-feedback residual within
  ``1e-4 · max|g|`` (both carry the gradients' error).

Each reference computation runs once (module fixtures: the reference's
eager ``lax.scan`` retraces at every call).  The port runs on
``device="cpu"``; the reference on JAX's CPU backend.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch import convert, tree
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, device_batch, synth_batch
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from test_torch_common import CPU

FAMILIES = ("internlm2-1.8b", "granite-moe-3b-a800m", "mamba2-780m",
            "zamba2-2.7b", "llama-3.2-vision-90b", "musicgen-large")
DENSE = "internlm2-1.8b"
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4          # of the leaf's max|g|
SMALL_GRAD = 1e-6          # of the leaf's max|g|: left out of STEP_TOL
STEP_TOL = dict(rtol=1e-5, atol=0.05 * OPT["lr"])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(arch: str, **kw):
    """The smoke config of ``arch`` in float32 on both packages."""
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(j_get_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _batch(cfg, global_batch=2, seq=16, step=0):
    """A ``synth_batch`` on the host, as jax arrays and as CPU tensors."""
    b = synth_batch(cfg, DataConfig(global_batch=global_batch, seq_len=seq),
                    step)
    return {k: jnp.asarray(v) for k, v in b.items()}, device_batch(cfg, b, CPU)


# -- the optimizer on identical grads ------------------------------------------


@pytest.fixture(scope="module")
def dense_state():
    """The dense smoke config in float32: the reference's state and three
    steps of numpy-seeded gradients shaped like its parameters."""
    jcfg, cfg = _cfgs(DENSE)
    js = jts.init_train_state(jcfg, jts.TrainConfig(), jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape, np.float32)
                              * rng.uniform(0.01, 1.0)), js["params"])
        for _ in range(3)]
    return dict(jcfg=jcfg, cfg=cfg, params=js["params"], grads=grads)


def test_lr_at_equals_reference():
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jopt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        want = np.asarray(jopt.lr_at(jcfg, jnp.asarray(step, jnp.int32)))
        got = opt.lr_at(ocfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(_np(got), want, rtol=1e-6)
        np.testing.assert_allclose(opt.lr_at(ocfg, step),
                                   np.asarray(jopt.lr_at(jcfg, step)),
                                   rtol=1e-6)


@pytest.mark.parametrize("stacked", [False, True])
def test_compress_decompress_equals_reference(stacked):
    """One tensor, or the blocks of a stacked leaf: they share the
    reference's one absmax scale."""
    rng = np.random.default_rng(3)
    shape = (3, 6, 5) if stacked else (6, 5)
    g = rng.standard_normal(shape).astype(np.float32)
    g[0] *= 10.0                           # block 0 sets the scale
    ef = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    deq, res = jopt._compress_decompress(jnp.asarray(g), jnp.asarray(ef))
    t = torch.from_numpy
    if stacked:
        pairs = opt._compress_decompress(list(t(g)), list(t(ef)))
    else:
        pairs = opt._compress_decompress([t(g)], [t(ef)])
    got_deq = np.stack([_np(d) for d, _ in pairs]).reshape(shape)
    got_res = np.stack([_np(r) for _, r in pairs]).reshape(shape)
    np.testing.assert_allclose(got_deq, np.asarray(deq), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_res, np.asarray(res), rtol=1e-6, atol=0)


@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_equals_reference(dense_state, compress):
    """Three steps on the same gradients: params, master, m, v, ef, step
    and the metrics within rtol 1e-6."""
    jcfg, cfg = dense_state["jcfg"], dense_state["cfg"]
    ocfg = dict(OPT, compress_grads=compress)
    jparams = dense_state["params"]
    jstate = jopt.init_opt_state(jopt.OptConfig(**ocfg), jparams)
    port = convert.train_state({"params": jparams, "opt": jstate}, cfg, CPU)
    params, state = port["params"], port["opt"]
    for jg in dense_state["grads"]:
        jparams, jstate, jm = jopt.apply_updates(jopt.OptConfig(**ocfg),
                                                 jparams, jg, jstate)
        params, state, m = opt.apply_updates(
            opt.OptConfig(**ocfg), params,
            convert.model_params(jg, cfg, CPU), state)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]),
                                       rtol=1e-6)
    want = convert.train_state({"params": jparams, "opt": jstate}, cfg, CPU)
    assert set(state) == set(want["opt"])
    assert int(state["step"]) == int(want["opt"]["step"]) == 3
    got_leaves = tree.leaves_with_paths({"params": params, "opt": state})
    want_leaves = tree.leaves_with_paths(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-9,
                                   err_msg=str(path))


def test_apply_updates_casts_params_from_master():
    """bf16 parameters become their float32 master cast to bf16, and the
    update writes the state's own tensors (the donated state)."""
    cfg = get_smoke_config(DENSE)
    state = ts.init_train_state(cfg, ts.TrainConfig(),
                                torch.Generator().manual_seed(0))
    master = tree.leaves(state["opt"]["master"])
    grads = tree.tree_map(torch.ones_like, state["params"])
    params, new, _ = opt.apply_updates(opt.OptConfig(**OPT),
                                       state["params"], grads, state["opt"])
    assert tree.leaves(new["master"])[0] is master[0]
    for p, mst in zip(tree.leaves(params), tree.leaves(new["master"])):
        assert p.dtype == torch.bfloat16 and mst.dtype == torch.float32
        torch.testing.assert_close(p, mst.to(torch.bfloat16), rtol=0, atol=0)


# -- train_loss and its gradients, every family --------------------------------


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """One family's smoke config in float32: the reference's loss,
    metrics and gradients on a ``synth_batch`` (B 2, S 16), and the
    port's state carried across."""
    jcfg, cfg = _cfgs(request.param)
    if cfg.family == "moe":
        assert cfg.capacity_factor * cfg.experts_per_token >= cfg.num_experts
    js = jts.init_train_state(jcfg, jts.TrainConfig(), jax.random.PRNGKey(1))
    jb, tb = _batch(cfg)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jtf.train_loss(jcfg, p, jb), has_aux=True)(js["params"])
    return dict(cfg=cfg, batch=tb, state=convert.train_state(js, cfg, CPU),
                loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=tree.leaves(convert.model_params(grads, cfg, CPU)))


def _check_grads(got: list, want: list, share: float):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        bound = share * max(float(w.abs().max()), 1e-30)
        err = float((g - w).abs().max())
        assert err <= bound, (err, bound)


def test_train_loss_and_grads_equal_reference(family):
    cfg = family["cfg"]
    (total, metrics), grads = ts.value_and_grad(cfg, family["state"]["params"],
                                                family["batch"])
    np.testing.assert_allclose(float(total), family["loss"], rtol=LOSS_RTOL)
    assert set(metrics) == set(family["metrics"])
    for k, want in family["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    _check_grads(grads, family["grads"], GRAD_SHARE)


def test_remat_keeps_loss_grads_and_serve_outputs():
    """``cfg.remat`` recomputes each block in the backward pass: the same
    loss and gradients (array-equal), and ``forward`` under no_grad (the
    serve path's) unchanged."""
    _, cfg = _cfgs(DENSE)
    remat = dataclasses.replace(cfg, remat=True)
    params = tf.init_params(cfg, torch.Generator().manual_seed(5))
    _, batch = _batch(cfg)
    (l0, _), g0 = ts.value_and_grad(cfg, params, batch)
    (l1, _), g1 = ts.value_and_grad(remat, params, batch)
    assert float(l0) == float(l1)
    _check_grads(g1, g0, 0.0)
    with torch.no_grad():
        f0, _ = tf.forward(cfg, params, batch["tokens"])
        f1, _ = tf.forward(remat, params, batch["tokens"])
    torch.testing.assert_close(f1, f0, rtol=0, atol=0)


# -- a whole train step ---------------------------------------------------------


@pytest.fixture(scope="module")
def dense_grads():
    """The dense smoke config's reference gradients on the train-step
    batch (B 4, S 16); with equal microbatches, the mean of theirs."""
    jcfg, cfg = _cfgs(DENSE)
    js = jts.init_train_state(jcfg, jts.TrainConfig(), jax.random.PRNGKey(1))
    jb, _ = _batch(cfg, global_batch=4)
    _, grads = jax.value_and_grad(
        lambda p: jtf.train_loss(jcfg, p, jb), has_aux=True)(js["params"])
    return tree.leaves(convert.model_params(grads, cfg, CPU))


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (1, True)])
def test_train_step_equals_reference(dense_grads, microbatches, compress):
    jcfg, cfg = _cfgs(DENSE)
    ocfg = dict(OPT, compress_grads=compress)
    jtcfg = jts.TrainConfig(microbatches=microbatches,
                            opt=jopt.OptConfig(**ocfg))
    tcfg = ts.TrainConfig(microbatches=microbatches, opt=opt.OptConfig(**ocfg))
    js = jts.init_train_state(jcfg, jtcfg, jax.random.PRNGKey(1))
    state = convert.train_state(js, cfg, CPU)
    jb, tb = _batch(cfg, global_batch=4)
    jnew, jm = jts.train_step(jcfg, jtcfg, js, jb)
    new, m = ts.train_step(cfg, tcfg, state, tb)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    want = convert.train_state(jnew, cfg, CPU)
    assert int(new["opt"]["step"]) == int(want["opt"]["step"]) == 1
    left_out = 0
    for part in (("params",), ("opt", "master")):
        got = tree.leaves(new[part[0]] if len(part) == 1
                          else new["opt"][part[1]])
        ref = tree.leaves(want[part[0]] if len(part) == 1
                          else want["opt"][part[1]])
        for g, w, grad in zip(got, ref, dense_grads, strict=True):
            keep = grad.abs() >= SMALL_GRAD * grad.abs().max()
            left_out += int((~keep).sum())
            np.testing.assert_allclose(_np(g[keep]), _np(w[keep]), **STEP_TOL)
    for part in ("m", "v", "ef"):       # the gradients' error, scaled
        if part in want["opt"]:
            for g, w, grad in zip(tree.leaves(new["opt"][part]),
                                  tree.leaves(want["opt"][part]), dense_grads,
                                  strict=True):
                scale = float(grad.abs().max()) if part == "ef" else \
                    float(w.abs().max())
                np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5,
                                           atol=GRAD_SHARE * scale)
    print(f"train_step microbatches={microbatches} compress={compress}: "
          f"{left_out} of the params' and master's entries left out "
          f"(|g| < {SMALL_GRAD}·max|g|)")


def test_loss_decreases_on_synthetic_stream():
    """30 steps on the learnable synthetic stream (the reference test's
    sizes and optimizer): the loss must drop."""
    cfg = dataclasses.replace(get_smoke_config(DENSE), vocab_size=256)
    tcfg = ts.TrainConfig(opt=opt.OptConfig(lr=3e-3, warmup_steps=5,
                                            total_steps=40))
    dcfg = DataConfig(global_batch=4, seq_len=32)
    state = ts.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0))
    losses = []
    for step in range(30):
        state, metrics = ts.train_step(
            cfg, tcfg, state, device_batch(cfg, synth_batch(cfg, dcfg, step),
                                           CPU))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses
