"""Rank programs of the LM's multi-device tests (``test_torch_lm_sharded.py``,
``test_torch_lm_moe_groups.py``).

Each function runs on every rank of ``repro_torch.launch.mesh.spawn``
(gloo on the CPU), installs the mesh's rules, builds its inputs from the
same seeds as the test's one-device run in the parent, and returns what
the parent compares: logits, caches and train states gathered whole, the
tokens each rank sampled, collective counts.  Only ``torch``, ``numpy``
and ``repro_torch`` are imported, so a rank starts without JAX.  The
models run in float32 (``f32``).
"""
import contextlib
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
from repro_torch.models import common as mc
from repro_torch.models import moe as moe_mod
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


def serve_steps(cfg, p, steps, max_len: int = L) -> tuple:
    """Prefill S tokens, 2 uniform decode steps, one per-slot decode step:
    the logits of each, and the cache."""
    prefill, decode, _ = steps
    tok = tokens(cfg)
    cache = tf.init_cache(cfg, B, max_len, device=CPU)
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


#: a chunked prefill: CHUNKS[0] tokens from 0, then CHUNKS[1] from there,
#: then one decode step, into a cache of ODD_L positions (4 does not divide)
CHUNKS, ODD_L = (6, 5), 30


def chunked_steps(cfg, p, steps, max_len: int = ODD_L) -> tuple:
    """A prompt prefilled in two chunks (the second from ``cache_len`` =
    CHUNKS[0]), then a decode step: the logits of each, and the cache."""
    prefill, decode, _ = steps
    n0, n1 = CHUNKS
    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, n0 + n1 + 1)))
    cache = tf.init_cache(cfg, B, max_len, device=CPU)
    with torch.no_grad():
        lg0, cache = prefill(p, tok[:, :n0], cache)
        lg1, cache = prefill(p, tok[:, n0:n0 + n1], cache, start=n0)
        lg2, cache = decode(p, tok[:, n0 + n1:], cache, n0 + n1)
    return [lg0, lg1, lg2], cache


def one_device_steps(cfg):
    return (lambda p, t, c, start=0: serve_prefill_step(cfg, p, t, c, start),
            lambda p, t, c, q: serve_decode_step(cfg, p, t, c, q), None)


def batcher_tokens(cfg, p, max_batch: int = 4, max_len: int = L) -> dict:
    """Five requests of 5-8 tokens through ContinuousBatcher (greedy)."""
    b = ContinuousBatcher(cfg, ServeConfig(max_batch=max_batch,
                                           max_len=max_len), p)
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


def attn_inputs(cfg) -> dict:
    """Seeded numpy inputs of one attention layer: the whole weights, the
    chunks of a prompt (CHUNKS, then one decode row) and a cache of ODD_L
    positions whose rows are noise until written."""
    rng = np.random.default_rng(11)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hdim

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    w = {"wq": f32(d, h * hd, scale=d ** -0.5),
         "wk": f32(d, kv * hd, scale=d ** -0.5),
         "wv": f32(d, kv * hd, scale=d ** -0.5),
         "wo": f32(h * hd, d, scale=(h * hd) ** -0.5)}
    xs = [f32(B, n, d) for n in CHUNKS + (1,)]
    return dict(w=w, xs=xs, k=f32(B, ODD_L, kv, hd), v=f32(B, ODD_L, kv, hd))


def attn_chunks(cfg, inputs: dict) -> dict:
    """``attn_forward`` on this rank over ``inputs`` (``attn_inputs``): the
    rank's blocks of the weights and of the sequence-split cache, the
    chunks at cache_len 0, CHUNKS[0] and sum(CHUNKS); every chunk's output
    and the cache gathered whole."""
    apl = tf._placements(cfg)["layers"][0]["attn_layers"][0]["attn"]
    p = {n: apl[n].local(torch.from_numpy(w)) for n, w in inputs["w"].items()}
    cpl = sh.get_rules().sharding(None, "seq_sp", None, None,
                                  ceil=(1, ODD_L))
    cache = {n: cpl.local(torch.from_numpy(inputs[n])) for n in ("k", "v")}
    outs, start = [], 0
    with torch.no_grad():
        for x in inputs["xs"]:
            n = x.shape[1]
            pos = torch.arange(start, start + n)[None]
            o, cache = mc.attn_forward(cfg, p, torch.from_numpy(x), pos,
                                       kv_cache=cache, cache_len=start)
            outs.append(o)
            start += n
    return dict(outs=outs, cache={n: cpl.gather(c) for n, c in cache.items()},
                local=tuple(cache["k"].shape))


def on_1x4_chunked() -> dict:
    """(data 1 × model 4), KV heads that do not split 4 ways (the dense
    smoke config's 2, ``heads_config("dense")``'s 3): a cache of ODD_L
    positions, a prompt prefilled in chunks and decoded, serving and the
    batcher at that length, and one attention layer over the chunks."""
    mesh = _mesh(4)
    out = {}
    for kind in ("dense", "heads"):
        cfg = f32(DENSE) if kind == "dense" else heads_config("dense")
        p = params(cfg)
        steps = make_sharded_serve_steps(cfg, mesh, p, B, ODD_L)
        lg, cache = chunked_steps(cfg, p, steps)
        out[kind, "chunked"] = lg
        out[kind, "cache"] = {g: {n: steps[2][g][n].gather(c)
                                  for n, c in t.items()}
                              for g, t in cache.items()}
        out[kind, "cache_local"] = tuple(cache["kv"]["k"].shape)
        out[kind, "serve"], _ = serve_steps(cfg, p, steps, ODD_L)
        out[kind, "tokens"] = batcher_tokens(cfg, p, max_len=ODD_L)
        acfg = attn_config(cfg)
        out[kind, "attn"] = attn_chunks(acfg, attn_inputs(acfg))
    return out


def attn_config(cfg):
    """``cfg`` with KV tiles of 8, so the reference's blockwise attention
    over the ODD_L cache runs several tiles."""
    return dataclasses.replace(cfg, attn_block=8)


# ---------------------------------------------------------------------------
# MoE dispatch groups on their data rank
# ---------------------------------------------------------------------------

#: the dispatch group size that makes a rank's rows whole groups at the
#: smoke sizes (2 rows a rank: 2 × 8 forward tokens, 2 × 16 train tokens)
SMALL_GROUP = 16


@contextlib.contextmanager
def moe_group(group: int):
    """``repro_torch.models.moe.GROUP`` set to ``group`` in the block."""
    saved = moe_mod.GROUP
    moe_mod.GROUP = group
    try:
        yield
    finally:
        moe_mod.GROUP = saved


@contextlib.contextmanager
def moe_record(R):
    """Inside the block, ``moe_forward``'s collectives: the list it
    yields gets the events of a ``collectives.scope`` open around each
    call, and ``batch_gathers`` the bytes of every all-gather over the
    batch axes among them."""
    record = dict(events=[], batch_gathers=[])
    fwd, gather = moe_mod.moe_forward, collectives.all_gather
    inside = [0]

    def counted_forward(*args, **kw):
        inside[0] += 1
        try:
            with collectives.scope(record["events"]):
                return fwd(*args, **kw)
        finally:
            inside[0] -= 1

    def counted_gather(t, group, size):
        if inside[0] and group is R.batch_group:
            record["batch_gathers"].append(size * t.numel() * t.element_size())
        return gather(t, group, size)
    moe_mod.moe_forward, collectives.all_gather = counted_forward, \
        counted_gather
    try:
        yield record
    finally:
        moe_mod.moe_forward, collectives.all_gather = fwd, gather


def rank_rows(t: torch.Tensor, R) -> torch.Tensor:
    per = t.shape[0] // R.D
    return t[R.d * per:(R.d + 1) * per]


def moe_grads(cfg, p, b: dict, R=None) -> tuple:
    """(metrics as floats, grads): ``train_loss``'s value and grad on
    ``b`` (a rank's rows under the mesh, the grads summed over the batch
    axes and gathered whole)."""
    with sh.batch_split(R is not None):
        (_, m), g = ts.value_and_grad(cfg, p, b)
    if R is not None:
        pl = leaves(tf._placements(cfg))
        g = [q.gather(t) for t, q in zip(ts._sync_grads(g, pl, R), pl,
                                         strict=True)]
    return {k: float(v) for k, v in m.items()}, [t.float() for t in g]


def moe_groups(model: int) -> dict:
    """(data 2 × model ``model``), the MoE smoke config in float32 on a
    batch split over data: with SMALL_GROUP (a rank's rows are whole
    groups) a forward, ``train_loss``'s value and grad and one train step;
    with the default GROUP (a group spans the ranks' rows) a forward.
    Each with the MoE's collective record."""
    _mesh(model)
    R = sh.ranks()
    cfg = f32(MOE)
    p = params(cfg)
    out = {}
    for group in (SMALL_GROUP, moe_mod.GROUP):
        with moe_group(group):
            with moe_record(R) as rec, torch.no_grad(), sh.batch_split():
                lg, aux = tf.forward(cfg, p, rank_rows(tokens(cfg), R))
            out[group, "forward"] = (lg, float(aux))
            out[group, "forward_record"] = rec
            if group != SMALL_GROUP:
                continue
            with moe_record(R) as rec:
                out["grads"] = moe_grads(cfg, p, rows(batch(cfg, 0), R), R)
            out["grads_record"] = rec
            state, ms = train(cfg, tcfg(), 1, R=R)
            out["train"] = ms
            out["state"] = gathered(cfg, tcfg(), state)
    return out
