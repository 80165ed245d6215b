"""Rank programs of the LM's multi-device tests (``test_torch_lm_sharded.py``).

Each function runs on every rank of ``repro_torch.launch.mesh.spawn``
(gloo on the CPU), installs the mesh's rules, builds its inputs from the
same seeds as the test's one-device run in the parent, and returns what
the parent compares: logits, caches and train states gathered whole, the
tokens each rank sampled, collective counts.  Only ``torch``, ``numpy``
and ``repro_torch`` are imported, so a rank starts without JAX.  The
models run in float32 (``f32``).
"""
import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.core.params import toy_params
from repro_torch.data.pipeline import DataConfig, device_batch, synth_batch
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.fault import (ElasticRunner, FaultConfig,
                                           SimulatedFailure)
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                      build_secure_serving,
                                      make_sharded_serve_steps,
                                      serve_decode_step, serve_prefill_step)
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptConfig
from repro_torch.tree import leaves

CPU = "cpu"
DENSE, MOE, SSM = "internlm2-1.8b", "granite-moe-3b-a800m", "mamba2-780m"
#: serve: a cache of B slots × L positions, a prompt of S, 2 decode steps
B, S, L = 4, 6, 32
#: train: global batch × sequence, the optimizer of the launcher
GB, SEQ = 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
#: the secure layer: toy CKKS, one 4-wide output tile
TOY = dict(logN=6, L=4, k=3, beta=2)
SECURE_OUT = 4


def f32(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def tokens(cfg, seed: int = 3) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 2)))


def params(cfg):
    return tf.init_params(cfg, torch.Generator().manual_seed(0))


def tcfg(mb: int = 1, compress: bool = False):
    return ts.TrainConfig(microbatches=mb, opt=OptConfig(
        **OPT, compress_grads=compress))


def batch(cfg, step: int) -> dict:
    """The global batch of ``step`` (every rank makes it whole)."""
    return device_batch(cfg, synth_batch(
        cfg, DataConfig(global_batch=GB, seq_len=SEQ), step), CPU)


def rows(b: dict, R) -> dict:
    """A rank's rows of a global batch (all of it off a data split)."""
    if R is None or R.D == 1:
        return b
    per = GB // R.D
    return {k: v[R.d * per:(R.d + 1) * per] for k, v in b.items()}


def serve_steps(cfg, p, steps) -> tuple:
    """Prefill S tokens, 2 uniform decode steps, one per-slot decode step:
    the logits of each, and the cache."""
    prefill, decode, _ = steps
    tok = tokens(cfg)
    cache = tf.init_cache(cfg, B, L, device=CPU)
    with torch.no_grad():
        lg, cache = prefill(p, tok[:, :S], cache)
        out = [lg]
        for i in range(2):
            lg, cache = decode(p, tok[:, S + i:S + i + 1], cache, S + i)
            out.append(lg)
        lg, cache = decode(p, tok[:, S + 1:S + 2], cache,
                           torch.tensor([S + 2, S + 1, S + 2, S + 3]))
        out.append(lg)
    return out, cache


def one_device_steps(cfg):
    return (lambda p, t, c: serve_prefill_step(cfg, p, t, c),
            lambda p, t, c, q: serve_decode_step(cfg, p, t, c, q), None)


def batcher_tokens(cfg, p, max_batch: int = 4) -> dict:
    """Five requests of 5-8 tokens through ContinuousBatcher (greedy)."""
    b = ContinuousBatcher(cfg, ServeConfig(max_batch=max_batch, max_len=L), p)
    rng = np.random.default_rng(0)
    for n in (5, 7, 6, 8, 5):
        b.submit(rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                 max_new=4)
    while b.step():
        pass
    return b.results


def train(cfg, tc, steps: int, state=None, start: int = 0, R=None):
    """``steps`` train steps from ``state`` (a fresh one when None) on the
    global batches from ``start``; (state, metrics as floats)."""
    state = ts.init_train_state(cfg, tc, torch.Generator().manual_seed(0)) \
        if state is None else state
    ms = []
    for step in range(start, start + steps):
        state, m = ts.train_step(cfg, tc, state, rows(batch(cfg, step), R))
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def gathered(cfg, tc, state) -> list:
    pl = ts.param_shardings(cfg, ts.abstract_train_state(cfg, tc),
                            sh.get_rules())
    return [q.gather(t) for t, q in zip(leaves(state), leaves(pl),
                                        strict=True)]


def secure_rows(cfg, p, he_mesh=None) -> dict:
    """The dense smoke config with layer 0 under HE (toy CKKS, a seeded
    d_model × 4 W), one request of 6 tokens decoding 2 more; the secure
    tier's contexts on ``he_mesh``."""
    cfg = dataclasses.replace(cfg, secure_layers=(0,))
    rng = np.random.default_rng(7)
    W = rng.standard_normal((cfg.d_model, SECURE_OUT)) * 0.05
    scfg = ServeConfig(max_batch=2, max_len=L, he_tile=4, he_mesh=he_mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        secure = build_secure_serving(cfg, scfg, {0: W}, rng,
                                      he_params=toy_params(**TOY),
                                      device=CPU)
        b = ContinuousBatcher(cfg, scfg, p, secure=secure)
        rid = b.submit(np.arange(6, dtype=np.int32) * 5, 2)
        while b.step():
            pass
    return dict(tokens=b.results[rid],
                rows=[out[0] for out in b.secure_results[rid]],
                schedules=sorted({prog._step1.plan.schedule for prog, _
                                  in secure.cache._entries.values()}))


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------


def _mesh(model: int):
    mesh = make_mesh_for(dist.get_world_size(), model, device=CPU,
                         backend="gloo")
    sh.set_rules(sh.make_rules(mesh))
    return mesh


def on_1x2(ckpt_dir: str) -> dict:
    """(data 1 × model 2): the collectives of one decode step, the secure
    layer on the LM's mesh, a train step that writes a checkpoint."""
    mesh = _mesh(2)
    cfg = f32(DENSE)
    p = params(cfg)
    out = {}
    steps = make_sharded_serve_steps(cfg, mesh, p, B, L)
    tok = tokens(cfg)
    cache = tf.init_cache(cfg, B, L, device=CPU)
    with torch.no_grad():
        _, cache = steps[0](p, tok[:, :S], cache)
        collectives.reset()
        steps[1](p, tok[:, S:S + 1], cache, S)
    out["decode_counts"] = dict(collectives.COUNTS)
    out["decode_bytes"] = dict(collectives.BYTES)
    out["secure"] = secure_rows(cfg, p, he_mesh=mesh)
    tc = tcfg()
    state, ms = train(cfg, tc, 1)
    ckpt.save(ckpt_dir, 1, state, shardings=ts.param_shardings(
        cfg, ts.abstract_train_state(cfg, tc), sh.get_rules()))
    out["train_1"] = ms
    return out


def on_2x2(ckpt_dir: str) -> dict:
    """(data 2 × model 2): forward, serving and the batcher for the dense,
    MoE and SSM smoke configs; 2 train steps of each with 2 microbatches
    and compressed gradients; the (1, 2) checkpoint resumed for its
    second step; the SSM train state gathered whole."""
    mesh = _mesh(2)
    R = sh.ranks()
    out = {}
    for arch in (DENSE, MOE, SSM):
        cfg = f32(arch)
        p = params(cfg)
        with torch.no_grad():
            out[arch, "forward"] = tf.forward(cfg, p, tokens(cfg))[0]
        steps = make_sharded_serve_steps(cfg, mesh, p, B, L)
        lg, cache = serve_steps(cfg, p, steps)
        out[arch, "serve"] = lg
        out[arch, "cache"] = {g: {n: steps[2][g][n].gather(c)
                                  for n, c in t.items()}
                              for g, t in cache.items()}
        out[arch, "tokens"] = batcher_tokens(cfg, p)
        tc = tcfg(2, True)
        state, ms = train(cfg, tc, 2, R=R)
        out[arch, "train"] = ms
        out[arch, "state"] = gathered(cfg, tc, state)
    cfg, tc = f32(DENSE), tcfg()
    whole = ts.abstract_train_state(cfg, tc)
    state, meta = ckpt.restore(ckpt_dir, whole, shardings=ts.param_shardings(
        cfg, whole, sh.get_rules()))
    out["resume_step"] = meta["step"]
    state, ms = train(cfg, tc, 1, state=state, start=1, R=R)
    out["resume_train"] = ms
    out["resume_state"] = gathered(cfg, tc, state)
    cfg = f32(SSM)
    tc = tcfg(1, True)
    fresh = ts.init_train_state(cfg, tc, torch.Generator().manual_seed(0))
    out["ssm_init"] = gathered(cfg, tc, fresh)
    out["elastic"] = elastic(f32(DENSE), tcfg(), ckpt_dir + "/elastic", R)
    out["rank"] = mesh.rank
    return out


def elastic(cfg, tc, ckpt_dir: str, R) -> dict:
    """``ElasticRunner`` on the mesh: 3 steps, a checkpoint each, a
    failure injected before step 2; ``remesh_fn`` (called once) returns
    the placements the restore slices by."""
    shardings = ts.param_shardings(cfg, ts.abstract_train_state(cfg, tc),
                                   sh.get_rules())
    calls = []

    def remesh():
        calls.append(1)
        return shardings

    fails = {2: True}

    def hook(step):
        if fails.pop(step, None):
            raise SimulatedFailure(f"injected at {step}")

    runner = ElasticRunner(
        ckpt_dir, FaultConfig(ckpt_every_steps=1),
        lambda s, b: ts.train_step(cfg, tc, s, b),
        lambda step: rows(batch(cfg, step), R),
        lambda: ts.abstract_train_state(cfg, tc), remesh_fn=remesh,
        shardings=shardings)
    state, n = runner.run(
        ts.init_train_state(cfg, tc, torch.Generator().manual_seed(0)), 3,
        fail_hook=hook)
    return dict(state=gathered(cfg, tc, state), steps=n,
                restarts=runner.restarts, remeshed=len(calls))


def on_1x4() -> dict:
    """(data 1 × model 4): the dense smoke config's 2 KV heads do not
    split 4 ways, so K/V are computed whole and the cache holds a block
    of the sequence (``seq_sp``, flash-decoding); the MoE's 8 experts
    split 4 ways."""
    mesh = _mesh(4)
    out = {}
    for arch in (DENSE, MOE):
        cfg = f32(arch)
        p = params(cfg)
        with torch.no_grad():
            out[arch, "forward"] = tf.forward(cfg, p, tokens(cfg))[0]
        steps = make_sharded_serve_steps(cfg, mesh, p, B, L)
        lg, cache = serve_steps(cfg, p, steps)
        out[arch, "serve"] = lg
        out[arch, "cache"] = {g: {n: steps[2][g][n].gather(c)
                                  for n, c in t.items()}
                              for g, t in cache.items()}
        out[arch, "cache_local"] = {g: {n: tuple(c.shape)
                                        for n, c in t.items()}
                                    for g, t in cache.items()}
        out[arch, "tokens"] = batcher_tokens(cfg, p)
    return out


def heads_config(kind: str):
    """Float32 smoke configs whose heads do not divide a model axis of 4:
    the dense one with 6 Q and 3 KV heads, the SSM one with 6 SSM heads
    (d_model 48, head_dim 16)."""
    if kind == "dense":
        return dataclasses.replace(f32(DENSE), d_model=48, num_heads=6,
                                   num_kv_heads=3)
    return dataclasses.replace(f32(SSM), d_model=48)


def on_1x4_heads() -> dict:
    """(data 1 × model 4) with ``heads_config``: forward, serving, the
    batcher, the collectives of a decode step, one train step, and the
    local shapes of the attention / SSM leaves (whole over ``model``)."""
    mesh = _mesh(4)
    out = {}
    for kind in ("dense", "ssm"):
        cfg = heads_config(kind)
        p = params(cfg)
        with torch.no_grad():
            out[kind, "forward"] = tf.forward(cfg, p, tokens(cfg))[0]
        steps = make_sharded_serve_steps(cfg, mesh, p, B, L)
        out[kind, "serve"], _ = serve_steps(cfg, p, steps)
        out[kind, "tokens"] = batcher_tokens(cfg, p)
        cache = tf.init_cache(cfg, B, L, device=CPU)
        with torch.no_grad():
            _, cache = steps[0](p, tokens(cfg)[:, :S], cache)
            collectives.reset()
            steps[1](p, tokens(cfg)[:, S:S + 1], cache, S)
        out[kind, "decode_counts"] = dict(collectives.COUNTS)
        blk = p["layers"][0]
        sub = (blk["attn_layers"][0]["attn"] if kind == "dense"
               else blk["ssm"][0])
        out[kind, "local"] = {k: tuple(t.shape) for k, t in sub.items()}
        _, ms = train(cfg, tcfg(), 1)
        out[kind, "train"] = ms
    return out
