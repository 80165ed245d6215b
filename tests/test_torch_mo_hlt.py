"""The reference's GSPMD MO-HLT prototype (``core/hlt_dist.py``
``build_tables`` / ``make_mo_hlt_fn``) and ``CompiledHLT.
sharded_collectives``, the counterpart of its ``sharded_hlo``.

* ``make_mo_hlt_fn(tabs, None)`` against the reference's at
  ``toy_params(logN=6, L=3, k=2, beta=2)``, d = 4, ctb = 2, on residues
  drawn with numpy from a seed: array-equal in float64 and in float32
  (the BaseConv floor's float type), every table equal;
* the same prototype on a ciphertext pair, its diagonals and rotation
  keys, array-equal to the port's one-device ``hlt(..., schedule="mo")``
  (the reference's own check, ``tests/test_distributed.py``, which does
  not run with the installed JAX);
* ``sharded_collectives`` of a toy σ / τ batch on spawned gloo ranks
  (data 1 × model 2): two all-reduces, whose bytes a rank sends total
  ``plan.collective_bytes``.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (x64)
from repro.core import hlt_dist as ref_dist
from repro.core.params import toy_params as ref_toy

import _sharded_ranks as sr
from repro_torch.core import automorph, hlt_dist
from repro_torch.core import modmath as mm
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.hlt import DiagSet, hlt
from repro_torch.core.params import toy_params, u32_numpy, u32_tensor
from repro_torch.launch.mesh import spawn

P = dict(logN=6, L=3, k=2, beta=2)
D, CTB = 4, 2


@pytest.fixture(scope="module")
def tables():
    return (ref_dist.build_tables(ref_toy(**P), d=D, ctb=CTB),
            hlt_dist.build_tables(toy_params(**P), d=D, ctb=CTB))


def _residues(rng, q, lead, rows):
    """uint32 residues of shape lead + (len(rows), N), row r below q[r]."""
    qs = q[rows].astype(np.uint64)[:, None]
    x = rng.integers(0, 2 ** 62, size=lead + (len(qs), 1 << P["logN"]),
                     dtype=np.uint64)
    return (x % qs).astype(np.uint32)


def test_tables_equal_reference(tables):
    ref, got = tables
    for f in ("q32", "qneg", "r2", "psi_m", "psii_m", "ninv_m", "perms",
              "p_raise_m"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f), err_msg=f)
    assert ref.full == got.full
    for r, g in zip(ref.digits + [ref.md], got.digits + [got.md],
                    strict=True):
        assert set(r) == set(g)
        for k in r:
            np.testing.assert_array_equal(np.asarray(r[k]), g[k], err_msg=k)


@pytest.mark.parametrize("fp", ["float64", "float32"])
def test_mo_hlt_fn_array_equal_to_reference(tables, fp):
    ref, got = tables
    rng = np.random.default_rng(5)
    q = got.q32[:, 0]
    M, L, nb = len(got.full), P["L"], len(got.digits)
    main = np.arange(L + 1)
    every = np.arange(M)
    args = (_residues(rng, q, (CTB,), main), _residues(rng, q, (CTB,), main),
            _residues(rng, q, (D,), every), _residues(rng, q, (D, nb), every),
            _residues(rng, q, (D, nb), every))
    want = ref_dist.make_mo_hlt_fn(ref, None, fp_dtype=getattr(jnp, fp))(
        *[jnp.asarray(a) for a in args])
    out = hlt_dist.make_mo_hlt_fn(got, None, fp_dtype=getattr(torch, fp))(
        *[u32_tensor(a, "cpu") for a in args])
    for w, o in zip(want, out, strict=True):
        assert o.shape == (CTB, L, 1 << P["logN"])
        np.testing.assert_array_equal(np.asarray(w), u32_numpy(o))


def test_mo_hlt_fn_array_equal_to_mo_schedule(tables):
    """Two ciphertexts, a DiagSet in the tables' rotation order and its
    rotation keys: the prototype equals the port's one-device ``mo``."""
    tabs = tables[1]
    params = toy_params(**P)
    eng = CkksEngine(params, device="cpu")
    rng = np.random.default_rng(0)
    zs = list(range(-(D // 2), D - D // 2))
    keys = eng.keygen(rng, rot_steps=[z for z in zs if z != 0])
    cts = [eng.encrypt(eng.encode(rng.normal(size=params.slots)), keys, rng)
           for _ in range(CTB)]
    full = list(range(params.num_total))
    pts = torch.stack([eng.encode_to_basis(rng.normal(size=params.slots),
                                           full, params.scale) for _ in zs])
    ds = DiagSet(zs=tuple(zs), pt=pts, scale=params.scale, shape=(8, 8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = [hlt(eng, c, ds, keys, schedule="mo") for c in cts]

    rows = np.asarray(tabs.full)
    q32, qneg, r2 = (u32_tensor(getattr(tabs, f), "cpu")
                     for f in ("q32", "qneg", "r2"))
    nb = len(tabs.digits)
    u_m = mm.to_mont(ds.pt[:, rows], q32, qneg, r2)
    rk0, rk1 = [], []
    for z in zs:
        if z == 0:
            rk0.append(torch.zeros((nb, len(rows), params.N),
                                   dtype=torch.int32))
            rk1.append(rk0[-1])
            continue
        key = keys.galois[automorph.galois_elt_rot(z, params.N)]
        rk0.append(mm.to_mont(key.k0[:nb][:, rows], q32, qneg, r2))
        rk1.append(mm.to_mont(key.k1[:nb][:, rows], q32, qneg, r2))
    out = hlt_dist.make_mo_hlt_fn(tabs, None, fp_dtype=torch.float64)(
        torch.stack([c.c0 for c in cts]), torch.stack([c.c1 for c in cts]),
        u_m, torch.stack(rk0), torch.stack(rk1))
    for i, w in enumerate(want):
        assert torch.equal(out[0][i], w.c0) and torch.equal(out[1][i], w.c1)


def test_sharded_collectives_equal_plan_bytes():
    """Each rank's body issues the merged ModDown's two all-reduces (one
    an output polynomial); with one ct rank the bytes a rank sends are
    the plan's reckoned ``collective_bytes``."""
    for r in spawn(sr.sharded_collectives_1x2, 2, device="cpu",
                   backend="gloo"):
        assert r["plan"] > 0
        assert r["count"] == 2 and len(r["largest"]) == 2
        assert r["total"] == r["plan"]
        assert r["by_op"] == {"all-reduce": r["plan"]}
