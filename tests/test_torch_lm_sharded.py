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
  flash-decoding) and the MoE's 8 experts split 4 ways;
* (data 1 × model 4) again, with KV heads that do not split 4 ways (the
  dense smoke config's 2, and 3 of 6 heads that replicate attention) and
  a cache of 30 positions, which 4 does not divide (a rank holds 8, the
  last rank's 2 past the end never written): a prompt prefilled in two
  chunks, the second from ``cache_len`` 6, then decoded, equal to one
  device (logits and the gathered cache); serving and the batcher at that
  length; one attention layer over the chunks against the reference's
  ``repro.models.common.attn_forward`` with a scalar ``cache_len``, run
  here on the same seeded numpy inputs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_ranks as lr
from repro.models import common as jc
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


@pytest.fixture(scope="module")
def mesh1x4_chunked():
    return spawn(lr.on_1x4_chunked, 4, device="cpu", backend="gloo")


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


def _odd_config(kind: str):
    return lr.f32(lr.DENSE) if kind == "dense" else lr.heads_config("dense")


_ODD: dict = {}


def one_device_odd(kind: str) -> dict:
    """The one-device port on a cache of ODD_L positions: the chunked
    prefill and its decode step, the cache, serving and the batcher."""
    if kind not in _ODD:
        cfg = _odd_config(kind)
        p = lr.params(cfg)
        steps = lr.one_device_steps(cfg)
        lg, cache = lr.chunked_steps(cfg, p, steps)
        serve, _ = lr.serve_steps(cfg, p, steps, lr.ODD_L)
        _ODD[kind] = dict(chunked=lg, cache=cache, serve=serve, params=p,
                          tokens=lr.batcher_tokens(cfg, p,
                                                   max_len=lr.ODD_L))
    return _ODD[kind]


@pytest.mark.parametrize("kind", ["dense", "heads"])
def test_chunked_prefill_into_a_seq_split_cache(mesh1x4_chunked, kind):
    """6 tokens from 0, then 5 from ``cache_len`` 6, then a decode step,
    into a cache of 30 positions on 4 model ranks: the logits of each and
    the gathered cache equal one device's; a rank holds ⌈30 / 4⌉ = 8
    positions of every KV head."""
    cfg = _odd_config(kind)
    want = one_device_odd(kind)
    for r in mesh1x4_chunked:
        for g, w in zip(r[kind, "chunked"], want["chunked"], strict=True):
            _close(g, w)
        for grp, tree in want["cache"].items():
            for n, c in tree.items():
                assert r[kind, "cache"][grp][n].shape == c.shape
                _close(r[kind, "cache"][grp][n], c)
        assert r[kind, "cache_local"] == (cfg.num_layers, 1, lr.B,
                                          -(-lr.ODD_L // 4), cfg.kv_heads,
                                          cfg.hdim)


def test_chunked_prefill_equals_one_prefill():
    """On one device the chunked prompt's last logits are those of one
    prefill of the 11 tokens (what the chunks stand for)."""
    cfg = lr.f32(lr.DENSE)
    p = one_device_odd("dense")["params"]
    n0, n1 = lr.CHUNKS
    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (lr.B, n0 + n1 + 1)))
    cache = tf.init_cache(cfg, lr.B, lr.ODD_L, device="cpu")
    with torch.no_grad():
        whole, _ = tf.prefill(cfg, p, tok[:, :n0 + n1], cache)
    _close(one_device_odd("dense")["chunked"][1], whole)


@pytest.mark.parametrize("kind", ["dense", "heads"])
def test_serving_with_a_cache_length_4_does_not_divide(mesh1x4_chunked,
                                                       kind):
    """Prefill + 2 decode steps + a per-slot one, and the batcher's
    tokens, with a cache of 30 positions on a model axis of 4."""
    want = one_device_odd(kind)
    for r in mesh1x4_chunked:
        for g, w in zip(r[kind, "serve"], want["serve"], strict=True):
            _close(g, w)
        assert r[kind, "tokens"] == want["tokens"]


@pytest.mark.parametrize("kind", ["dense", "heads"])
def test_attn_chunks_equal_the_reference(mesh1x4_chunked, kind):
    """One attention layer on 4 model ranks over a sequence-split cache of
    30 positions (noise until written), at ``cache_len`` 0, 6 and 11,
    against the reference's ``attn_forward`` with the scalar
    ``cache_len`` (``dynamic_update_slice``, then blockwise attention
    from ``q_offset``) on the whole cache: outputs and the cache."""
    cfg = lr.attn_config(_odd_config(kind))
    jcfg = jc.ModelConfig(**dataclasses.asdict(cfg))
    inp = lr.attn_inputs(cfg)
    jp = {n: jnp.asarray(w) for n, w in inp["w"].items()}
    jkv = {n: jnp.asarray(inp[n]) for n in ("k", "v")}
    outs, start = [], 0
    for x in inp["xs"]:
        n = x.shape[1]
        pos = jnp.arange(start, start + n, dtype=jnp.int32)[None]
        o, jkv = jc.attn_forward(jcfg, jp, jnp.asarray(x), pos, kv_cache=jkv,
                                 cache_len=start)
        outs.append(torch.from_numpy(np.array(o)))
        start += n
    for r in mesh1x4_chunked:
        got = r[kind, "attn"]
        assert got["local"][1] == -(-lr.ODD_L // 4)
        for g, w in zip(got["outs"], outs, strict=True):
            _close(g, w)
        for n in ("k", "v"):
            _close(got["cache"][n], torch.from_numpy(np.array(jkv[n])))
