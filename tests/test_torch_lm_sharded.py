"""The LM's tensor, expert and data parallelism on spawned gloo ranks of
the CPU, against the one-device port run in this process from the same
seeds (the reference's own sharded tests do not run with the installed
JAX; the one-device port is held to the reference in
``test_torch_models.py``, ``test_torch_families.py`` and
``test_torch_train.py``).  Float32 throughout; the bound is ``TOL``
(1e-4) on logits, caches, losses and gathered states, except the
error-feedback int8 compression, whose rounding a float-order difference
can flip by one quantum (``test_train_two_steps``: at most ``FLIPS`` of
the entries, the rest within ``TOL``).

Each mesh shape is spawned once (a module fixture, ``tests/_lm_ranks.py``):

* (data 1 × model 2): the collectives of one decode step against the
  reckoned count (an all-reduce a row-parallel product, two a layer, one
  for the vocab-parallel embedding, one all-gather of the logits); the
  dense smoke config served with a toy secure layer whose ``he_mesh`` is
  the LM's mesh (the sharded HLT on the same ranks), its secure rows
  array-equal to one device; a train step that writes a checkpoint;
* (data 2 × model 2): forward logits, prefill + 2 decode steps + a
  per-slot one and the gathered cache, ContinuousBatcher tokens (equal on
  every rank and to one device), 2 train steps with 2 microbatches and
  compressed gradients, for the dense, MoE (dropless) and SSM smoke
  configs; the (1, 2) checkpoint resumed for a second step, equal to an
  uninterrupted run; ``ElasticRunner`` through an injected failure
  (``remesh_fn`` giving the restore its placements) equal to 3
  uninterrupted steps; the SSM train state gathered whole (the packed
  ``in_proj`` / ``conv_w`` included), equal to one device's;
* (data 1 × model 4): the dense smoke config's 2 KV heads do not split
  4 ways (K/V whole on every rank, the cache's sequence split,
  flash-decoding) and the MoE's 8 experts split 4 ways.
"""
import numpy as np
import pytest
import torch

import _lm_ranks as lr
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as tf
from repro_torch.tree import leaves

TOL = 1e-4
FLIPS = 1e-3          # share of entries an int8 rounding flip may move


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("lm_ckpt"))


@pytest.fixture(scope="module")
def mesh1x2(ckpt_dir):
    return spawn(lr.on_1x2, 2, ckpt_dir, device="cpu", backend="gloo")


@pytest.fixture(scope="module")
def mesh2x2(mesh1x2, ckpt_dir):
    return spawn(lr.on_2x2, 4, ckpt_dir, device="cpu", backend="gloo")


@pytest.fixture(scope="module")
def mesh1x4():
    return spawn(lr.on_1x4, 4, device="cpu", backend="gloo")


_ONE: dict = {}


def one_device(arch: str) -> dict:
    """The one-device port's forward, serve steps, cache and tokens."""
    if arch not in _ONE:
        cfg = lr.f32(arch)
        p = lr.params(cfg)
        with torch.no_grad():
            fwd = tf.forward(cfg, p, lr.tokens(cfg))[0]
        lg, cache = lr.serve_steps(cfg, p, lr.one_device_steps(cfg))
        _ONE[arch] = dict(forward=fwd, serve=lg, cache=cache,
                          tokens=lr.batcher_tokens(cfg, p), params=p)
    return _ONE[arch]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)


def _metrics_close(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


def _check_serving(outs, arch):
    want = one_device(arch)
    for r in outs:
        _close(r[arch, "forward"], want["forward"])
        for g, w in zip(r[arch, "serve"], want["serve"], strict=True):
            _close(g, w)
        for grp, tree in want["cache"].items():
            for n, c in tree.items():
                _close(r[arch, "cache"][grp][n], c)
        assert r[arch, "tokens"] == want["tokens"]


@pytest.mark.parametrize("arch", [lr.DENSE, lr.MOE, lr.SSM])
def test_serving_2x2(mesh2x2, arch):
    _check_serving(mesh2x2, arch)


@pytest.mark.parametrize("arch", [lr.DENSE, lr.MOE])
def test_serving_1x4(mesh1x4, arch):
    _check_serving(mesh1x4, arch)


def test_seq_split_cache_on_1x4(mesh1x4):
    """2 KV heads on 4 model ranks: each rank's cache holds every KV head
    and a quarter of the sequence."""
    cfg = lr.f32(lr.DENSE)
    for r in mesh1x4:
        k = r[lr.DENSE, "cache_local"]["kv"]["k"]
        assert k == (cfg.num_layers, 1, lr.B, lr.L // 4, cfg.kv_heads,
                     cfg.hdim)


def _train_one_device(arch, mb, compress, steps=2):
    cfg = lr.f32(arch)
    return lr.train(cfg, lr.tcfg(mb, compress), steps)


@pytest.mark.parametrize("arch", [lr.DENSE, lr.MOE, lr.SSM])
def test_train_two_steps(mesh2x2, arch):
    """2 steps, 2 microbatches, compressed gradients: the metrics within
    TOL; the gathered state within TOL but for int8 rounding flips (an
    entry of g + ef a float-order step from a rounding boundary moves its
    residual and its update by a quantum), at most FLIPS of it."""
    state, ms = _train_one_device(arch, 2, True)
    want = leaves(state)
    for r in mesh2x2:
        _metrics_close(r[arch, "train"], ms)
        far = total = 0
        for g, w in zip(r[arch, "state"], want, strict=True):
            assert g.shape == w.shape and g.dtype == w.dtype
            far += int(((g.float() - w.float()).abs() > TOL).sum())
            total += w.numel()
        assert far <= FLIPS * total, (far, total)


def test_packed_ssm_state_gathers_whole(mesh2x2):
    """The SSM's fresh train state, gathered from every rank's blocks
    (``in_proj`` and ``conv_w`` by their segments), is the one-device
    state exactly."""
    cfg = lr.f32(lr.SSM)
    tc = lr.tcfg(1, True)
    want = leaves(lr.ts.init_train_state(cfg, tc,
                                         torch.Generator().manual_seed(0)))
    for r in mesh2x2:
        for g, w in zip(r["ssm_init"], want, strict=True):
            assert torch.equal(g, w)


def test_resume_from_1x2_onto_2x2(mesh1x2, mesh2x2):
    """A checkpoint written on (data 1 × model 2) after step 1 restores on
    (data 2 × model 2); its step 2 equals 2 uninterrupted one-device
    steps."""
    state, ms = _train_one_device(lr.DENSE, 1, False)
    for r in mesh1x2:
        _metrics_close(r["train_1"], ms[:1])
    for r in mesh2x2:
        assert r["resume_step"] == 1
        _metrics_close(r["resume_train"], ms[1:])
        for g, w in zip(r["resume_state"], leaves(state), strict=True):
            _close(g.float(), w.float())


def test_elastic_runner_on_the_mesh(mesh2x2):
    """3 steps with a checkpoint each and a failure before step 2: the
    runner calls ``remesh_fn`` once, restores the rank's blocks from the
    whole checkpoint and ends equal to 3 uninterrupted one-device
    steps."""
    state, _ = _train_one_device(lr.DENSE, 1, False, steps=3)
    for r in mesh2x2:
        e = r["elastic"]
        assert (e["steps"], e["restarts"], e["remeshed"]) == (3, 1, 1)
        for g, w in zip(e["state"], leaves(state), strict=True):
            _close(g.float(), w.float())


def test_decode_step_collectives_as_reckoned(mesh1x2):
    """One decode step on (data 1 × model 2), 2 layers: an all-reduce
    after each row-parallel product (attention's and the MLP's ``wo``)
    and one for the vocab-parallel embedding, one all-gather of the
    logits; nothing else."""
    cfg = lr.f32(lr.DENSE)
    layers = cfg.num_layers
    for r in mesh1x2:
        c = r["decode_counts"]
        assert c["all_reduce"] == 2 * layers + 1
        assert c["all_gather"] == 1
        assert sum(c.values()) == 2 * layers + 2
        # a row-parallel output (B, 1, d) f32 a rank; the logits gathered
        assert r["decode_bytes"]["all_reduce"] == \
            (2 * layers + 1) * lr.B * cfg.d_model * 4
        assert r["decode_bytes"]["all_gather"] == lr.B * cfg.vocab_size * 4


def test_secure_layer_on_the_lm_mesh(mesh1x2):
    """The dense smoke config with a toy secure layer whose ``he_mesh`` is
    the LM's (1, 2) mesh: the flush runs the sharded HLT on the LM's
    ranks, and every rank's tokens and secure rows are one device's,
    array-equal."""
    cfg = lr.f32(lr.DENSE)
    want = lr.secure_rows(cfg, one_device(lr.DENSE)["params"])
    for r in mesh1x2:
        got = r["secure"]
        assert got["schedules"] == ["sharded"]
        assert got["tokens"] == want["tokens"]
        assert len(got["rows"]) == len(want["rows"]) >= 2
        for g, w in zip(got["rows"], want["rows"]):
            np.testing.assert_array_equal(g, w)
