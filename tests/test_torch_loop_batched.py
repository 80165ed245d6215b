"""The product loop as batches: the engine's ``mult``, ``key_switch``,
``rescale``, ``sum`` and ``RnsTools.base_conv`` on (B, ℓ+1, N) polynomials
against a loop of B single calls, on both engine datapaths; the chunked
loop of ``HEMMProgram`` and ``BlockMMProgram`` (``compile.product_sums``)
against the per-product loop on the same Step-2 outputs, with chunks that
cut across the products and a ragged last one; and
``costmodel.loop_chunk`` at Set-B and Set-C.  Residues are compared
exactly; imports no JAX (the single ops are held against the reference in
``test_torch_engine.py``, the programs in ``test_torch_hemm_s.py`` and
``test_torch_blockmm.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core import compile as compile_mod
from repro_torch.core.ckks import Ciphertext, CkksEngine
from repro_torch.core.compile import HEContext, compile_blockmm, compile_hemm
from repro_torch.core.costmodel import (hlt_transient_bytes, loop_chunk,
                                        loop_transient_bytes, step2_chunk)
from repro_torch.core.hemm import encrypt_matrix, plan_hemm
from repro_torch.core.params import SET_B, SET_C
from repro_torch.secure import SecureMatmulEngine

B = 3


def _equal(a: torch.Tensor, b: torch.Tensor) -> None:
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _ct_equal(a: Ciphertext, b: Ciphertext) -> None:
    _equal(a.c0, b.c0)
    _equal(a.c1, b.c1)
    assert (a.level, a.scale) == (b.level, b.scale)


@pytest.fixture(scope="module", params=[
    (name, dp) for name in FAME_VERIFY_SETS for dp in ("xla", "pallas")])
def eng_cts(request):
    """An engine, its keys and 2·B fresh ciphertexts at level L."""
    name, dp = request.param
    eng = CkksEngine(FAME_VERIFY_SETS[name], device="cpu", datapath=dp)
    rng = np.random.default_rng(31)
    keys = eng.keygen(rng)
    cts = [eng.encrypt(eng.encode(m), keys, rng)
           for m in rng.uniform(-1, 1, (2 * B, eng.params.slots))]
    return eng, keys, cts


def _batch(cts) -> Ciphertext:
    return Ciphertext(torch.stack([c.c0 for c in cts]),
                      torch.stack([c.c1 for c in cts]), cts[0].level,
                      cts[0].scale)


def test_engine_ops_batched_equal_single(eng_cts):
    eng, keys, cts = eng_cts
    a, b = cts[:B], cts[B:]
    ell = a[0].level
    got = eng.mult(_batch(a), _batch(b), keys)
    singles = [eng.mult(x, y, keys) for x, y in zip(a, b, strict=True)]
    _ct_equal(got, _batch(singles))
    k0, k1 = eng.key_switch(got.c1, keys.evk_mult, ell)
    for i, ct in enumerate(singles):
        s0, s1 = eng.key_switch(ct.c1, keys.evk_mult, ell)
        _equal(k0[i], s0)
        _equal(k1[i], s1)
    _ct_equal(eng.rescale(got), _batch([eng.rescale(c) for c in singles]))
    total = singles[0]
    for ct in singles[1:]:
        total = eng.add(total, ct)
    _ct_equal(eng.sum(got), total)


def test_key_switch_below_the_top_level(eng_cts):
    """A level with fewer digits: the key's rows are two slices."""
    eng, keys, cts = eng_cts
    low = [eng.mod_drop(c, c.level - 2) for c in cts[:B]]
    ell = low[0].level
    k0, k1 = eng.key_switch(_batch(low).c1, keys.evk_mult, ell)
    for i, ct in enumerate(low):
        s0, s1 = eng.key_switch(ct.c1, keys.evk_mult, ell)
        _equal(k0[i], s0)
        _equal(k1[i], s1)


def test_base_conv_batched_equals_single(eng_cts):
    eng, _, cts = eng_cts
    p = eng.params
    S, T = tuple(range(3)), tuple(range(3, p.num_total))
    x = torch.stack([c.c0[:3] for c in cts])                # (2B, 3, N)
    got = eng.tools.base_conv(x, S, T)
    assert got.shape == (2 * B, len(T), p.N)
    for i in range(2 * B):
        _equal(got[i], eng.tools.base_conv(x[i], S, T))


def _loop(eng, keys, pairs) -> Ciphertext:
    """The per-product loop: add(…add(rescale(mult(a0, b0)), …), …)."""
    acc = None
    for a, b in pairs:
        prod = eng.rescale(eng.mult(a, b, keys))
        acc = prod if acc is None else eng.add(acc, prod)
    return acc


def _record_step2(prog, monkeypatch) -> list:
    """Keep each call's Step-2 outputs."""
    seen, step2 = [], prog._step2

    def run(items):
        out = step2(items)
        seen.append(out)
        return out
    monkeypatch.setattr(prog, "_step2", run)
    return seen


@pytest.fixture(scope="module")
def hemm():
    rng = np.random.default_rng(32)
    ctx = HEContext(CkksEngine(FAME_VERIFY_SETS["fame-m-rt"], device="cpu",
                               datapath="pallas"))
    plan = plan_hemm(ctx.eng, 4, 5, 4)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    cts = (encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (4, 5)), rng),
           encrypt_matrix(ctx.eng, ctx.keys, rng.uniform(-1, 1, (5, 4)), rng))
    return ctx, compile_hemm(ctx, plan, schedule="pallas"), cts


@pytest.mark.parametrize("size", [None, 1, 2, 3])
def test_chunked_hemm_equals_per_product_loop(hemm, monkeypatch, size):
    """l = 5 products in chunks of the cost model's size (3 chunks of 2, 2
    and 1 here) or of 1, 2 (ragged) and 3 (ragged)."""
    ctx, prog, (ctA, ctB) = hemm
    l = prog.mm_plan.l
    if size is not None:
        monkeypatch.setattr(compile_mod, "loop_chunk", lambda *a: size)
    else:
        size = loop_chunk(ctx.eng.params, prog.plan.level - 2, l, 2 * l)
        assert size == 2
    seen = _record_step2(prog, monkeypatch)
    c0 = dict(ctx.counters)
    got = prog(ctA, ctB)
    outs, = seen
    assert ctx.counters["he.loop_chunk.calls"] - c0.get(
        "he.loop_chunk.calls", 0) == -(-l // size)
    _ct_equal(got, _loop(ctx.eng, ctx.keys, zip(outs[:l], outs[l:])))


@pytest.fixture(scope="module")
def blockmm():
    rng = np.random.default_rng(33)
    te = SecureMatmulEngine(FAME_VERIFY_SETS["fame-s-rt"], tile=4,
                            device="cpu")
    te.keygen(rng)
    At = te.encrypt_tiles(rng.uniform(-1, 1, (6, 5)), rng)
    Bt = te.encrypt_tiles(rng.uniform(-1, 1, (5, 7)), rng)
    return te, compile_blockmm(te.ctx, te._plan, (2, 2, 2)), At, Bt


@pytest.mark.parametrize("size", [None, 5, 32])
def test_chunked_blockmm_equals_per_product_loop(blockmm, monkeypatch, size):
    """2·2·2·4 = 32 products, 8 a tile: chunks of 5 cut across the tiles
    and leave 2; one chunk of all 32; the cost model's size."""
    te, prog, At, Bt = blockmm
    if size is not None:
        monkeypatch.setattr(compile_mod, "loop_chunk", lambda *a: size)
    seen = _record_step2(prog, monkeypatch)
    got = prog(At, Bt)
    res, = seen
    gm, gl, gn = prog.plan.grid
    l, nA, nB = prog.mm_plan.l, gm * gl, gl * gn
    for i in range(gm):
        for j in range(gn):
            pairs = [(res[kk * nA + i * gl + k],
                      res[l * nA + kk * nB + k * gn + j])
                     for kk in range(l) for k in range(gl)]
            _ct_equal(got[i][j], _loop(te.eng, te.ctx.keys, pairs))


@pytest.mark.parametrize("params,l,chunk,chunks", [(SET_B, 128, 64, 2),
                                                   (SET_C, 75, 25, 3)])
def test_loop_chunk_at_the_cells(params, l, chunk, chunks):
    """The hemm l³ loop at level L − 2: Set-B 128 products in 2 chunks of
    64, Set-C 75 in 3 of 25; each chunk within what Step 2 frees once its
    results are written (Set-B 256 × (12.06 − 3.67) MB, Set-C 150 ×
    (45.09 − 15.73) MB, one Step-2 chunk each)."""
    level = params.L - 2
    assert loop_chunk(params, level, l, 2 * l) == chunk
    assert step2_chunk(params, level + 1, 2 * l) == 2 * l
    result = 2 * (level + 1) * 4 * params.N         # a Step-2 output
    freed = 2 * l * (hlt_transient_bytes(params, level + 1) - result)
    assert chunk * loop_transient_bytes(params, level) <= freed
    cap = freed // loop_transient_bytes(params, level)     # 64 / 32
    assert -(-l // chunk) == -(-l // cap) == chunks    # as few as fit
