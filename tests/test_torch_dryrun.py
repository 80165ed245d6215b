"""The compile-time cost reports: ``distributed/hlo_cost.py``'s counter,
``launch/dryrun.py`` on fake process groups, against the reference's
``hlo_cost.analyze`` where both count the same program.

* The reference's four ``tests/test_hlo_cost.py`` cases in counter form:
  a loop of 7 matmuls counted once and multiplied (``trip_counts``), a
  plain dot, a slice in a loop charged as the slice, an all-reduce
  repeated 5 times on a fake 2-rank group.
* The ``internlm2-1.8b`` smoke config's decode step (4 × 1 tokens
  against a 64-long cache) and train step (``TrainConfig()``, 2 × 64):
  the port's dot FLOPs on one device equal the reference's
  ``hlo_cost.analyze`` of the single-device ``jax.jit`` of the same step.
* Per rank × ranks on a fake (data 2 × model 2) group equals the
  one-device count; with heads that do not divide the model axis (6 Q
  and 3 KV heads on model 4) a decode step exceeds it by exactly the
  three extra copies of the replicated q / k / v / o projections.
* ``run_cell`` on the fake 256-rank production mesh at smoke widths
  writes the reference's key set; ``main`` names its files as the
  reference's and writes the ``long_500k`` skip record.
* ``run_he_cell("set-b", "pod")``: ``collective_bytes_total`` is the
  sharded plan's reckoned bytes for a rank's share (one ciphertext, 16
  model ranks: ``costmodel.sharded_collective_bytes``) × chips.
"""
import contextlib
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import repro  # noqa: F401  (x64)
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.distributed import hlo_cost as ref_hlo_cost
from repro.models import transformer as ref_tf
from repro.serve.engine import serve_decode_step as ref_decode
from repro.train import train_step as ref_ts

import _lm_ranks as lr
from repro_torch.configs import get_smoke_config
from repro_torch.core.costmodel import sharded_collective_bytes
from repro_torch.core.params import SET_B
from repro_torch.distributed import collectives, hlo_cost
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import transformer as tf
from repro_torch.train import train_step as ts

ARCH = "internlm2-1.8b"
DEC_B, DEC_LEN, POS = 4, 64, 10        # decode: 4 × 1 tokens, 64-long cache
TR_B, TR_S = 2, 64                     # train: 2 × 64 tokens

#: the reference's record keys (``generated_code_size_in_bytes`` has no
#: counterpart and is left out, as the reference leaves out a key it
#: cannot read)
LM_KEYS = {"arch", "shape", "mesh", "chips", "step", "ok", "compile_s",
           "flops_total", "hbm_bytes_total", "collective_bytes_total",
           "collectives_by_op", "raw_cost_analysis", "trip_counts",
           "roofline", "dominant", "model_flops", "useful_flops_ratio",
           "memory_analysis", "model_params"}
HE_KEYS = {"arch", "shape", "mesh", "chips", "ok", "compile_s",
           "flops_total", "hbm_bytes_total", "collective_bytes_total",
           "collectives_by_op", "roofline", "dominant", "memory_analysis"}
MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"}


# ---------------------------------------------------------------------------
# (a) the reference's four counter cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad", [False, True])
def test_loop_flops_counted_with_trip_count(grad):
    """On fake tensors without a gradient the loop's body runs once,
    counted 7 times; with one (its backward would escape the scope)
    every iteration runs: the same FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    d, L = 64, 7
    with FakeTensorMode(), torch.set_grad_enabled(grad), \
            hlo_cost.count() as c:
        x, ws = torch.ones(8, d), torch.ones(L, d, d)
        h = x
        for i in hlo_cost.loop(L, "layers"):
            h = torch.tanh(h @ ws[i])
    cost = c.cost()
    assert cost.flops == 2 * 8 * d * d * L
    assert cost.trip_counts == ({} if grad else {"layers": L})


def test_loop_runs_every_body_on_real_tensors():
    """On real tensors the loop runs all 7 bodies, counted one by one:
    the values are those of a plain loop, the FLOPs the folded count's."""
    d, L = 16, 7
    gen = torch.Generator().manual_seed(3)
    x, ws = torch.randn(8, d, generator=gen), torch.randn(L, d, d,
                                                           generator=gen)
    want = x
    for i in range(L):
        want = torch.tanh(want @ ws[i])
    with torch.no_grad(), hlo_cost.count() as c:
        h = x
        for i in hlo_cost.loop(L, "layers"):
            h = torch.tanh(h @ ws[i])
    assert torch.equal(h, want)
    assert c.cost().flops == 2 * 8 * d * d * L
    assert c.cost().trip_counts == {}


@pytest.mark.parametrize("arch", [ARCH, "mamba2-780m"])
def test_real_prefill_unchanged_under_the_counter(arch):
    """A real no-grad prefill whose blockwise attention (3 KV blocks) or
    SSD chunk loop (3 chunks) goes through ``hlo_cost.loop`` gives the
    same logits and cache inside ``count()`` as outside it."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              attn_block=16)
    p = tf.init_params(cfg, torch.Generator().manual_seed(5))
    tok = torch.randint(0, cfg.vocab_size, (2, 40),
                        generator=torch.Generator().manual_seed(6))
    outs = []
    for counted in (False, True):
        cache = tf.init_cache(cfg, 2, 48, device="cpu")
        with torch.no_grad(), (hlo_cost.count() if counted
                               else contextlib.nullcontext()):
            outs.append(tf.prefill(cfg, p, tok, cache))
    (l0, c0), (l1, c1) = outs
    assert torch.equal(l0, l1)
    for a, b in zip(torch.utils._pytree.tree_leaves(c0),
                    torch.utils._pytree.tree_leaves(c1), strict=True):
        assert torch.equal(a, b)


def test_dot_flops_basic():
    with hlo_cost.count() as c:
        torch.ones(32, 128) @ torch.ones(128, 64)
    assert c.cost().flops == 2 * 32 * 128 * 64


def test_bytes_model_slice_vs_full():
    """A slice inside a loop is charged as the slice, not the operand
    (full-operand counting: 64 × 256 KB ≈ 16 MB)."""
    big = torch.ones(64, 1024)
    with torch.no_grad(), hlo_cost.count() as c:
        acc = torch.zeros(())
        for i in hlo_cost.loop(64, "scan"):
            acc = acc + big[i:i + 1].sum()
    assert c.cost().bytes_accessed < 4e6


def test_collectives_scale_with_trips():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        group = dist.new_group([0, 1], backend="fake")
        with hlo_cost.count() as c, c.repeat(5, "while"):
            collectives.all_reduce_sum(torch.ones(128), group)
    finally:
        dist.destroy_process_group()
    cost = c.cost()
    assert cost.collective_bytes == 5 * 128 * 4
    assert cost.collectives_by_op == {"all-reduce": 5 * 128 * 4}


# ---------------------------------------------------------------------------
# (b) dot FLOPs against the reference's loop-aware HLO count
# ---------------------------------------------------------------------------


def _ref_flops(step: str) -> float:
    cfg = ref_smoke(ARCH)
    sds = jax.ShapeDtypeStruct
    if step == "decode":
        params = jax.eval_shape(lambda: ref_tf.init_params(
            cfg, jax.random.PRNGKey(0)))
        cache = jax.eval_shape(lambda: ref_tf.init_cache(cfg, DEC_B, DEC_LEN))
        lowered = jax.jit(functools.partial(ref_decode, cfg)).lower(
            params, sds((DEC_B, 1), jnp.int32), cache,
            sds((), jnp.int32))
    else:
        tcfg = ref_ts.TrainConfig()
        state = ref_ts.abstract_train_state(cfg, tcfg)
        batch = {k: sds((TR_B, TR_S), jnp.int32)
                 for k in ("tokens", "targets")}
        lowered = jax.jit(functools.partial(ref_ts.train_step, cfg,
                                            tcfg)).lower(state, batch)
    return ref_hlo_cost.analyze(lowered.compile().as_text()).flops


def _port_count(cfg, step: str, rows: slice = slice(None)):
    """The counter over one ``step`` of ``cfg`` under the current rules
    (one device without a mesh), on CPU tensors (fake ones under the
    caller's ``FakeTensorMode``)."""
    if step == "decode":
        p = tf.init_params(cfg, torch.Generator().manual_seed(0))
        cache = tf.init_cache(cfg, DEC_B, DEC_LEN, device="cpu")
        tok = torch.zeros(DEC_B, 1, dtype=torch.int64)
        with torch.no_grad(), sh.batch_split(sh.ranks() is not None), \
                hlo_cost.count() as c:
            tf.decode_step(cfg, p, tok[rows], cache, POS)
        return c.cost()
    tc = ts.TrainConfig()
    state = ts.init_train_state(cfg, tc, torch.Generator().manual_seed(0))
    batch = {k: torch.zeros(TR_B, TR_S, dtype=torch.int64)[rows]
             for k in ("tokens", "targets")}
    with hlo_cost.count() as c:
        ts.train_step(cfg, tc, state, batch)
    return c.cost()


@pytest.mark.parametrize("step", ["decode", "train"])
def test_dot_flops_equal_reference_hlo_count(step):
    """Equal, not within a tolerance: the smoke config has no remat
    (``remat=False``), so neither side recomputes a forward."""
    cfg = get_smoke_config(ARCH)
    assert not cfg.remat
    got = _port_count(cfg, step).flops
    assert got == _ref_flops(step)
    assert got == {"decode": 983_040, "train": 94_371_840}[step]


# ---------------------------------------------------------------------------
# (c) per rank × ranks on fake groups
# ---------------------------------------------------------------------------


def _on_fake_mesh(world: int, model: int, cfg, step: str):
    """Rank 0's count of ``step`` on a fake (world / model × model) mesh,
    under FakeTensorMode: the rank's parameters, cache and rows."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_mesh_for(world, model, device="cpu", backend="fake")
        sh.set_rules(sh.make_rules(mesh))
        R = sh.ranks()
        with FakeTensorMode(allow_non_fake_inputs=True):
            per = (DEC_B if step == "decode" else TR_B) // R.D
            return _port_count(cfg, step, slice(R.d * per, (R.d + 1) * per))
    finally:
        sh.set_rules(sh.make_rules())
        dist.destroy_process_group()


@pytest.mark.parametrize("step", ["decode", "train"])
def test_per_rank_times_ranks_equals_one_device(step):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    one = _port_count(cfg, step).flops
    assert _on_fake_mesh(4, 2, cfg, step).flops * 4 == one


def test_replicated_heads_exceed_by_the_replicated_projections():
    """6 Q and 3 KV heads on (data 1 × model 4): every rank runs the q /
    k / v / o projections whole (the cache's sequence still splits, so
    the attention over it does not repeat); the MLP, the logits and the
    rest split 4 ways."""
    cfg = lr.heads_config("dense")
    one = _port_count(cfg, "decode").flops
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hdim
    proj = 2 * DEC_B * d * (2 * h * hd + 2 * kv * hd) * cfg.num_layers
    assert _on_fake_mesh(4, 4, cfg, "decode").flops * 4 == one + 3 * proj


# ---------------------------------------------------------------------------
# (d), (e) the records
# ---------------------------------------------------------------------------


def _smoke_overrides(arch: str) -> dict:
    sm = get_smoke_config(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if f.name != "name"}


def test_run_cell_record_keys():
    rec = dryrun.run_cell(ARCH, "decode_32k", "pod",
                          overrides=_smoke_overrides(ARCH), device="cpu")
    assert set(rec) == LM_KEYS
    assert set(rec["memory_analysis"]) == MEM_KEYS
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert rec["ok"] and rec["chips"] == 256 and rec["step"] == "decode"
    assert rec["flops_total"] > 0 and rec["collective_bytes_total"] > 0
    assert rec["dominant"] in rec["roofline"]
    assert not dist.is_initialized()


def test_main_writes_the_reference_file_names(tmp_path):
    """A full-attention arch's ``long_500k`` cell is the reference's
    skip record, in ``<arch>__<shape>__<mesh><suffix>.json``."""
    assert dryrun.main(["--arch", ARCH, "--shape", "long_500k", "--mesh",
                        "both", "--suffix", "_t", "--out", str(tmp_path),
                        "--device", "cpu"]) == 0
    for mesh in ("pod", "multipod"):
        rec = json.loads((tmp_path / f"{ARCH}__long_500k__{mesh}_t.json")
                         .read_text())
        assert rec["ok"] and rec["skipped"].startswith("full-attention")


def test_he_cell_collective_bytes_are_the_plans():
    rec = dryrun.run_he_cell("set-b", "pod", device="cpu")
    assert set(rec) == HE_KEYS and set(rec["memory_analysis"]) == MEM_KEYS
    assert rec["chips"] == 256 and rec["ok"]
    want = sharded_collective_bytes(SET_B, n_model=16, ctb=1) * 256
    assert rec["collective_bytes_total"] == want
    assert rec["collectives_by_op"] == {"all-reduce": want}
    assert rec["flops_total"] > 0 and rec["hbm_bytes_total"] > 0
    assert not dist.is_initialized()
