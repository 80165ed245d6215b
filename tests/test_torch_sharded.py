"""The port's multi-device HE schedule on spawned gloo ranks of the CPU,
against the JAX reference's one-device ``mo`` run in this process from
the same seeds — the port's counterparts of ``tests/test_sharded.py``.

Each mesh shape is spawned once (``repro_torch.launch.mesh.spawn``, a
module fixture) and runs several cases (``tests/_sharded_ranks.py``);
every rank returns its outputs, and each must be array-equal to the
reference's:

* the σ / τ / ε HLT batch on ``model`` 4 for both of the reference's
  parameter cases, one with M = 6 extended limbs that 4 does not divide
  (the limb-padding path);
* ``compile_hemm`` on (data 2 × model 2), and a 3-wide batch on the 2-way
  ciphertext axis (batch padding);
* ``"sharded"`` (rotation_chunk 2, an aliased batch: the dedup layout)
  against ``"sharded_xla"``, and a mostly distinct batch (the element
  layout);
* the census under ``verify="error"``: 2 all-reduces an HLT launch and no
  other collective, no named NTT on the fused stages and some on
  ``HEContext(datapath="xla")``; a planted extra collective draws JX001,
  a planted named NTT JX004;
* ranks that hash strings differently (another ``PYTHONHASHSEED`` each)
  are refused when they build a mesh: the serving flush iterates a set of
  tenants, so their collectives would pair up across programs.
"""
import numpy as np
import pytest

import repro  # noqa: F401
from repro.core.ckks import CkksEngine as JEngine
from repro.core.compile import HEContext as JContext
from repro.core.compile import compile_hemm as j_compile_hemm
from repro.core.compile import compile_hlt as j_compile_hlt
from repro.core.hemm import encrypt_matrix as j_encrypt
from repro.core.hemm import plan_hemm as j_plan_hemm
from repro.core.params import toy_params as j_toy

import _sharded_ranks as ranks
from repro_torch.launch.mesh import spawn
from test_torch_common import u32

#: (name, toy_params arguments): the second has M = L+1+k = 6 extended
#: limbs, which model 4 does not divide
PARAM_CASES = [
    ("logN6-L4-k3-div", dict(logN=6, L=4, k=3, beta=2, scale_bits=26)),
    ("logN6-L3-k2-pad", dict(logN=6, L=3, k=2, beta=2, scale_bits=26)),
]
TOY = dict(logN=6, L=4, k=3, beta=2, scale_bits=26)


def assert_equal(jct, got):
    c0, c1, level, scale = got
    np.testing.assert_array_equal(u32(jct.c0), c0)
    np.testing.assert_array_equal(u32(jct.c1), c1)
    assert (jct.level, jct.scale) == (level, scale)


def _ref_pair(kw, seed):
    rng = np.random.default_rng(seed)
    ctx = JContext(JEngine(j_toy(**kw)))
    plan = j_plan_hemm(ctx.eng, 4, 3, 5)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    a = j_encrypt(ctx.eng, ctx.keys, rng.uniform(-1, 1, (4, 3)), rng)
    b = j_encrypt(ctx.eng, ctx.keys, rng.uniform(-1, 1, (4, 3)), rng)
    return ctx, plan, rng, a, b


def _mo(ctx, items):
    return [j_compile_hlt(ctx, ds, level=it.level, schedule="mo")(it)
            for it, ds in items]


@pytest.fixture(scope="module")
def model4():
    return spawn(ranks.hlt_on_model4, 4, PARAM_CASES, device="cpu",
                 backend="gloo")


@pytest.fixture(scope="module")
def mesh2x2():
    return spawn(ranks.on_2x2, 4, device="cpu", backend="gloo")


@pytest.mark.parametrize("name,kw", PARAM_CASES,
                         ids=[c[0] for c in PARAM_CASES])
def test_sharded_hlt_on_model4_equals_reference_mo(model4, name, kw):
    ctx, plan, _, ctA, ctB = _ref_pair(kw, 7)
    want = _mo(ctx, [(ctA, plan.ds_sigma), (ctB, plan.ds_tau),
                     (ctA, plan.ds_eps[0])])
    for rank in model4:
        got = rank[name]
        for w, g in zip(want, got["outs"], strict=True):
            assert_equal(w, g)
        assert got["n_model"] == 4 and got["coll"] > 0
        if "pad" in name:
            assert (got["M"], got["M_pad"]) == (6, 8)   # limb padding
        else:
            assert got["M_pad"] == got["M"]


def test_census_of_the_fused_and_xla_stages(model4):
    ctx, plan, _, ctA, ctB = _ref_pair(TOY, 13)
    want = _mo(ctx, [(ctA, plan.ds_sigma), (ctB, plan.ds_tau)])
    for rank in model4:
        fused, xla = rank["census"]["pallas"], rank["census"]["xla"]
        for res in (fused, xla):
            for w, g in zip(want, res["outs"], strict=True):
                assert_equal(w, g)
            assert res["collectives"] == {"all_reduce": 2}
        assert (fused["datapath"], xla["datapath"]) == ("pallas", "xla")
        assert fused["ntt"] == {}                       # JX004 holds
        assert sum(xla["ntt"].values()) > 0
        assert fused["calls"]["fused_hlt_indexed"] == 1
        assert fused["calls"]["moddown_finish"] == 1
        assert "moddown_finish" not in xla["calls"]


def test_sharded_hemm_2x2_and_batch_padding(mesh2x2):
    rng = np.random.default_rng(3)
    ctx = JContext(JEngine(j_toy(**TOY)))
    m, l, n = 4, 3, 5
    plan = j_plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    A, B = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    ctA = j_encrypt(ctx.eng, ctx.keys, A, rng)
    ctB = j_encrypt(ctx.eng, ctx.keys, B, rng)
    mo = j_compile_hemm(ctx, plan, schedule="mo")(ctA, ctB)
    want3 = _mo(ctx, [(ctA, plan.ds_sigma), (ctB, plan.ds_tau),
                      (ctB, plan.ds_sigma)])
    coords = set()
    for rank in mesh2x2:
        got = rank["hemm"]
        assert_equal(mo, got["hemm"])
        assert got["err"] < 0.05
        for w, g in zip(want3, got["batch3"], strict=True):
            assert_equal(w, g)
        assert got["b_pad"] == 4                    # 3 padded to 2 ct ranks
        assert (got["n_ct"], got["n_model"]) == (2, 2) and got["coll"] > 0
        coords.add((got["ct_rank"], got["model_rank"]))
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_sharded_vs_sharded_xla_and_hoist_layouts(mesh2x2):
    ctx, plan, rng, ctA, ctB = _ref_pair(TOY, 5)
    sets = [plan.ds_sigma, plan.ds_tau, plan.ds_sigma]
    want = _mo(ctx, list(zip([ctA, ctB, ctA], sets, strict=True)))
    dis = [j_encrypt(ctx.eng, ctx.keys, rng.uniform(-1, 1, (4, 3)), rng)
           for _ in range(4)]
    want_d = _mo(ctx, [(d, plan.ds_sigma) for d in dis])
    for rank in mesh2x2:
        got = rank["fused_vs_xla"]
        for key in ("fused", "xla"):
            for w, g in zip(want, got[key], strict=True):
                assert_equal(w, g)
        for w, g in zip(want_d, got["distinct"], strict=True):
            assert_equal(w, g)
        assert (got["layout_aliased"], got["n_uniq_packed"]) == ("dedup", 2)
        # 4 distinct > a ct rank's share of 2: each rank hoists its own
        assert (got["layout_distinct"], got["distinct_packed"]) == \
            ("element", 2)
        assert got["distinct_slots"] == [0, 1]      # rank-local slots
        assert got["xla_packed"] == 2               # its share of 3 -> 4
        assert got["hoist"] < got["hoist_naive"] == got["hoist_xla"]
        assert got["census"] == [[2, 0]] * 3


def test_planted_collective_and_ntt_are_errors(mesh2x2):
    for rank in mesh2x2:
        got = rank["fused_vs_xla"]
        assert got["extra_gather"] == [("JX001", "error")]
        assert got["named_ntt"] == [("JX004", "error")]


def test_mesh_refuses_ranks_with_different_hash_seeds():
    got = ranks.start_with_hash_seeds(ranks.mesh_or_refusal, (1, 2))
    for rank, msg in enumerate(got):
        assert "PYTHONHASHSEED" in msg and f"rank {rank} hashes" in msg, msg
