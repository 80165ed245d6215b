"""Shared parity helpers for the PyTorch port's tests (``test_torch_*``).

Inputs come from a numpy seed and go through the JAX reference (``repro``,
Pallas kernels in interpret mode on the CPU, as its own tests run them)
and the port (``repro_torch``, ``device="cpu"``: the kernels' plain
versions).  Residues are compared exactly as uint32 arrays.
"""
import numpy as np

import repro  # noqa: F401  (enables jax x64 before any jax array exists)
import repro.configs.fame_sets as jfs
from repro.core.ckks import CkksEngine as JEngine
from repro.core.compile import HEContext as JContext
from repro.core.compile import compile_hemm as j_compile_hemm
from repro.core.hemm import encrypt_matrix as j_encrypt_matrix
from repro.core.hemm import plan_hemm as j_plan_hemm

from repro_torch import convert
from repro_torch.configs.fame_sets import FAME_VERIFY_SETS
from repro_torch.core.ckks import CkksEngine
from repro_torch.core.compile import HEContext, compile_hemm
from repro_torch.core.hemm import encrypt_matrix, plan_hemm
from repro_torch.core.params import u32_numpy

CPU = "cpu"
CHUNK = 2          # pads d 5 -> 6 (fame-s-rt) and 7 -> 8 (fame-m-rt)

#: the numeric fields an ``HLTPlan`` shares with the reference's
PLAN_FIELDS = ("schedule", "level", "batch", "nbeta", "chunk", "d", "d_pad",
               "diag_slots", "n_diag_slots", "rotations", "operand_bytes",
               "operand_bytes_naive", "stage_costs", "collective_bytes",
               "n_model", "n_ct", "ct_slots", "n_ct_slots", "hoist_bytes",
               "hoist_bytes_naive", "dedup_factor")


def u32(a) -> np.ndarray:
    """A jax array or an int32 tensor -> its uint32 numpy bits."""
    if hasattr(a, "detach"):
        return u32_numpy(a)
    return np.asarray(a).astype(np.uint32)


def assert_ct_equal(jct, tct):
    np.testing.assert_array_equal(u32(jct.c0), u32(tct.c0))
    np.testing.assert_array_equal(u32(jct.c1), u32(tct.c1))
    assert jct.level == tct.level and jct.scale == tct.scale


def run_slice(name: str, shape, seed: int) -> dict:
    """One reference hemm (schedule="pallas") and the port's hemm twice:
    with same-seed keys and with the reference's keys, ciphertexts and plan
    carried across by ``repro_torch.convert``."""
    m, l, n = shape
    rng = np.random.default_rng(seed)
    jctx = JContext(JEngine(jfs.FAME_VERIFY_SETS[name]))
    jplan = j_plan_hemm(jctx.eng, m, l, n)
    jctx.keygen(rng, rot_steps=jplan.rot_steps)
    A = rng.uniform(-1, 1, (m, l))
    B = rng.uniform(-1, 1, (l, n))
    jA = j_encrypt_matrix(jctx.eng, jctx.keys, A, rng)
    jB = j_encrypt_matrix(jctx.eng, jctx.keys, B, rng)
    jprog = j_compile_hemm(jctx, jplan, schedule="pallas", rotation_chunk=CHUNK)
    jC = jprog(jA, jB)

    # same seed, the port's own keygen / plan / encryption
    rng = np.random.default_rng(seed)
    ctx = HEContext(CkksEngine(FAME_VERIFY_SETS[name], device=CPU))
    plan = plan_hemm(ctx.eng, m, l, n)
    ctx.keygen(rng, rot_steps=plan.rot_steps)
    tA_in, tB_in = rng.uniform(-1, 1, (m, l)), rng.uniform(-1, 1, (l, n))
    np.testing.assert_array_equal(tA_in, A)
    tA = encrypt_matrix(ctx.eng, ctx.keys, tA_in, rng)
    tB = encrypt_matrix(ctx.eng, ctx.keys, tB_in, rng)
    prog = compile_hemm(ctx, plan, schedule="pallas", rotation_chunk=CHUNK)
    counters0 = dict(ctx.counters)
    tC = prog(tA, tB)
    counters1 = dict(ctx.counters)

    # the reference's keys, ciphertexts and plan carried across
    cctx = HEContext(CkksEngine(FAME_VERIFY_SETS[name], device=CPU),
                     keys=convert.keys(jctx.keys, CPU))
    cplan = convert.hemm_plan(jplan, CPU)
    cprog = compile_hemm(cctx, cplan, schedule="pallas", rotation_chunk=CHUNK)
    cC = cprog(convert.ciphertext(jA, CPU), convert.ciphertext(jB, CPU))
    return dict(A=A, B=B, shape=shape, jctx=jctx, jplan=jplan, jprog=jprog,
                jA=jA, jB=jB, jC=jC, ctx=ctx, plan=plan, prog=prog, tA=tA,
                tB=tB, tC=tC, counters=(counters0, counters1), cctx=cctx,
                cprog=cprog, cC=cC)
