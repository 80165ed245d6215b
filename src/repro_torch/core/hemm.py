"""Homomorphic Encrypted Matrix Multiplication (paper §II-C, Algorithm 2):
the transformation matrices, the plan and the matrix encrypt/decrypt —
counterpart of ``repro/core/hemm.py``.

A_{m×l} × B_{l×n} = Σ_k (ε^k∘σ(A)) ⊙ (ω^k∘τ(B)), each transformation an
HLT over the column-major flattened matrix.  Every matrix has one entry
per row, so the plan encodes its diagonals from the sparse form; the
dense ``u_*`` functions build the same matrices as the reference.
Execution is ``compile_hemm`` (core/compile.py); ``hemm()`` is the
reference's deprecated one-call shim over it.  ``plan_hemm_chain`` plans
a chain Y = X·W1·…·Wk of hemm hops (``compile_hemm_chain`` runs it).

The paper's §VI-A baselines run on the same engine: E2DM-S (pad to
square), E2DM-R (pad to a rectangle-compatible shape) and Huang et al.
(the general method, one KeySwitch a rotation) on the ``baseline``
schedule, HEGMM-En (this module's method) on ``hoisted``
(``baseline_spec``, ``hemm_baseline``).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np

from repro_torch.core.ckks import Ciphertext, CkksEngine, Keys
from repro_torch.core.hlt import DiagSet, SparseMatrix, encode_diagonals


def _sparse(shape, rows, cols) -> SparseMatrix:
    rows = np.asarray(rows, np.int64).ravel()
    return SparseMatrix(shape, rows, np.asarray(cols, np.int64).ravel(),
                        np.ones(rows.size))


def sigma_map(m: int, l: int) -> SparseMatrix:
    i = np.arange(m)[:, None]
    j = np.arange(l)[None, :]
    return _sparse((m * l, m * l), i + j * m, i + ((i + j) % l) * m)


def tau_map(l: int, n: int) -> SparseMatrix:
    i = np.arange(l)[:, None]
    j = np.arange(n)[None, :]
    return _sparse((l * n, l * n), i + j * l, ((i + j) % l) + j * l)


def eps_map(k: int, m: int, l: int, n: int) -> SparseMatrix:
    r = np.arange(m * n)
    return _sparse((m * n, m * l), r, (k * m + r) % (m * l))


def omega_map(k: int, m: int, l: int, n: int) -> SparseMatrix:
    r = np.arange(m * n)
    return _sparse((m * n, l * n), r, (k + r % m) % l + (r // m) * l)


def _dense(s: SparseMatrix) -> np.ndarray:
    U = np.zeros(s.shape, dtype=np.float64)
    U[s.rows, s.cols] = s.vals
    return U


def u_sigma(m: int, l: int) -> np.ndarray:
    return _dense(sigma_map(m, l))


def u_tau(l: int, n: int) -> np.ndarray:
    return _dense(tau_map(l, n))


def u_eps(k: int, m: int, l: int, n: int) -> np.ndarray:
    return _dense(eps_map(k, m, l, n))


def u_omega(k: int, m: int, l: int, n: int) -> np.ndarray:
    return _dense(omega_map(k, m, l, n))


def diag_count_formulas(m: int, l: int, n: int) -> dict:
    """Paper Eqs. 12–15: diagonals of σ, τ, each ε^k and each ω^k."""
    return {
        "sigma": 2 * min(m, l) - 1,
        "tau": 2 * min(n, l) - 1,
        "eps": n // l + 1,
        "omega": 2 if m == l else n * (m // l + 2),
    }


def diag_count_exact(m: int, l: int, n: int) -> dict:
    """Exact diagonal counts (per-k lists for ε/ω).  Eqs. 14–15 hold when
    l | n (ε) and m = l or l | m (ω), and are off by a small constant
    otherwise (4-3-5 has an ε^2 with 3 diagonals, not ⌊n/l⌋ + 1 = 2)."""
    r = np.arange(m * n)
    eps = [len(np.unique((k * m + r) % (m * l) - r)) for k in range(l)]
    omg = [len(np.unique((k + r % m) % l + (r // m) * l - r))
           for k in range(l)]
    return {"sigma": 2 * min(m, l) - 1, "tau": 2 * min(n, l) - 1,
            "eps": eps, "omega": omg}


def min_logN(m: int, l: int, n: int) -> int:
    """Slots must hold both inputs AND the m×n output."""
    need = 2 * max(m * l, l * n, m * n)
    return max(1, math.ceil(math.log2(need)))


@dataclasses.dataclass
class HeMMPlan:
    m: int
    l: int
    n: int
    ds_sigma: DiagSet
    ds_tau: DiagSet
    ds_eps: list
    ds_omega: list
    rot_steps: tuple

    @property
    def total_rotations(self) -> int:
        return (self.ds_sigma.d + self.ds_tau.d
                + sum(d.d for d in self.ds_eps)
                + sum(d.d for d in self.ds_omega))


def plan_hemm(eng: CkksEngine, m: int, l: int, n: int,
              scale: Optional[float] = None) -> HeMMPlan:
    p = eng.params
    if max(m * l, l * n, m * n) > p.slots:
        raise ValueError(f"{(m, l, n)} needs logN >= {min_logN(m, l, n)} "
                         f"(have {p.logN})")
    enc = lambda U: encode_diagonals(eng, U, scale)
    ds_sigma = enc(sigma_map(m, l))
    ds_tau = enc(tau_map(l, n))
    ds_eps = [enc(eps_map(k, m, l, n)) for k in range(l)]
    ds_omega = [enc(omega_map(k, m, l, n)) for k in range(l)]
    steps = set()
    for ds in [ds_sigma, ds_tau, *ds_eps, *ds_omega]:
        steps.update(z for z in ds.zs if z != 0)
    return HeMMPlan(m, l, n, ds_sigma, ds_tau, ds_eps, ds_omega,
                    tuple(sorted(steps)))


def encrypt_matrix(eng: CkksEngine, keys: Keys, X: np.ndarray,
                   rng: np.random.Generator, level: Optional[int] = None,
                   scale: Optional[float] = None) -> Ciphertext:
    """Column-major flatten into the first rows·cols slots (paper Fig. 1).
    ``level`` / ``scale`` default to the top level and ``params.scale``; a
    chain encrypts each weight at its hop's input level
    (``HEMMChainProgram.encrypt_weights``)."""
    vec = np.asarray(X, dtype=np.float64).flatten(order="F")
    return eng.encrypt(eng.encode(vec, level=level, scale=scale), keys, rng)


def decrypt_matrix(eng: CkksEngine, keys: Keys, ct: Ciphertext,
                   m: int, n: int) -> np.ndarray:
    vals = eng.decrypt_decode(ct, keys, num=m * n).real
    return vals.reshape((m, n), order="F")


# ---------------------------------------------------------------------------
# chains: Y = X·W1·W2·…·Wk under encryption, no decrypt between the hops
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainRepack:
    """The re-pack between hop h and hop h+1.

    A hemm leaves hop h's m×n product column-major in slots [0, m·n), and
    ``encode_diagonals`` clips every diagonal of U to its rows' support,
    so hop h+1's σ (an m·l' × m·l' transform, l' = n) never reads a slot
    ≥ m·n.  The re-pack is therefore the identity fold: the output window
    is the next hop's σ input as it stands, whatever lies beyond it is
    never read, and no level is spent between hops.

    ``chain_repack`` checks the hand-off; ``repack="explicit"`` in
    ``plan_hemm_chain`` encodes σ∘repack as its own DiagSet — the same
    matrix, bit for bit, but a distinct operand that costs one arena slot
    a boundary: the hook for input layouts that are not an identity
    fold."""
    rows: int        # m (carried through the chain)
    cols: int        # n of the previous hop == l of the next
    window: int      # rows·cols slots the previous hop's output fills

    def sparse(self) -> SparseMatrix:
        """The re-pack over the next hop's σ domain (m·l × m·l)."""
        i = np.arange(self.rows * self.cols)
        return _sparse((i.size, i.size), i, i)

    def matrix(self) -> np.ndarray:
        """The re-pack as a dense matrix (the identity, for the native
        column-major layout)."""
        return _dense(self.sparse())


def _compose(S: SparseMatrix, R: SparseMatrix) -> SparseMatrix:
    """S·R for an R with one entry per row (a re-pack)."""
    col = np.full(R.shape[0], -1, np.int64)
    val = np.zeros(R.shape[0])
    col[R.rows], val[R.rows] = R.cols, R.vals
    keep = col[S.cols] >= 0
    return SparseMatrix((S.shape[0], R.shape[1]), S.rows[keep],
                        col[S.cols][keep], (S.vals * val[S.cols])[keep])


def chain_repack(prev: HeMMPlan, nxt: HeMMPlan) -> ChainRepack:
    """Check the hand-off of hop h to hop h+1 and return its re-pack."""
    if prev.m != nxt.m:
        raise ValueError(f"a chain carries m: the hop's output is "
                         f"{prev.m}x{prev.n}, the next takes m={nxt.m}")
    if prev.n != nxt.l:
        raise ValueError(f"shape chain broken: the hop's output is "
                         f"{prev.m}x{prev.n}, the next is "
                         f"{nxt.m}x{nxt.l}·{nxt.l}x{nxt.n}")
    # the next σ's domain is the previous output window
    if nxt.ds_sigma.shape != (prev.m * prev.n, prev.m * prev.n):
        raise ValueError(f"next σ is {nxt.ds_sigma.shape}, the window "
                         f"{prev.m * prev.n}")
    return ChainRepack(rows=prev.m, cols=prev.n, window=prev.m * prev.n)


@dataclasses.dataclass
class HeMMChainPlan:
    """Math plan of Y = X·W1·…·Wk.  ``dims = (m, l, n1, …, nk)``: hop h
    multiplies (m × dims[h+1]) by (dims[h+1] × dims[h+2])."""
    dims: tuple
    hops: tuple            # HeMMPlan per hop (equal shapes share one plan)
    repacks: tuple         # ChainRepack per boundary (k − 1 of them)
    repack: str            # "fold" (identity, no operand) | "explicit"
    rot_steps: tuple       # union over the hops: one keygen serves the chain

    @property
    def k(self) -> int:
        return len(self.hops)


def plan_hemm_chain(eng: CkksEngine, dims, scale: Optional[float] = None,
                    repack: str = "fold") -> HeMMChainPlan:
    """Plan a chain of k = len(dims) − 2 hops, ``dims = (m, l, n1, …,
    nk)``.  Hops of equal (m, l, n) share one HeMMPlan, cached on the
    engine (``_chain_hop_plans``), so chains planned in separate calls
    share it too and its DiagSets take one arena slot per compile point."""
    if repack not in ("fold", "explicit"):
        raise ValueError(f"repack={repack!r}: \"fold\" or \"explicit\"")
    dims = tuple(int(d) for d in dims)
    if len(dims) < 4:
        raise ValueError("a chain needs >= 2 hops: dims = (m, l, n1, n2, …)")
    m = dims[0]
    by_shape = getattr(eng, "_chain_hop_plans", None)
    if by_shape is None:
        by_shape = eng._chain_hop_plans = {}
    hops = []
    for h in range(len(dims) - 2):
        key = (m, dims[h + 1], dims[h + 2], scale)
        if key not in by_shape:
            by_shape[key] = plan_hemm(eng, *key[:3], scale=scale)
        hops.append(by_shape[key])
    repacks = tuple(chain_repack(hops[h], hops[h + 1])
                    for h in range(len(hops) - 1))
    if repack == "explicit":
        # σ∘repack for each interior hop: the same matrix, a distinct
        # DiagSet, so its own arena slot
        hops = [hops[0]] + [
            dataclasses.replace(
                hops[h + 1],
                ds_sigma=encode_diagonals(
                    eng, _compose(sigma_map(hops[h + 1].m, hops[h + 1].l),
                                  rp.sparse()), scale))
            for h, rp in enumerate(repacks)]
    steps = set()
    for hp in hops:
        steps.update(hp.rot_steps)
    return HeMMChainPlan(dims, tuple(hops), repacks, repack,
                         tuple(sorted(steps)))


def hemm(eng: CkksEngine, ctA: Ciphertext, ctB: Ciphertext, plan: HeMMPlan,
         keys: Keys, schedule: Optional[str] = "mo",
         rotation_chunk: Optional[int] = None,
         batched: Optional[bool] = None) -> Ciphertext:
    """Algorithm 2; consumes 3 levels.  DEPRECATED shim: compiles an
    HEMMProgram on a pooled HEContext (``legacy_context``) and runs it."""
    warnings.warn(
        "hemm(..., schedule=...) is deprecated: build an HEContext and use "
        "repro_torch.core.compile.compile_hemm instead.", DeprecationWarning,
        stacklevel=2)
    from repro_torch.core.compile import compile_hemm, legacy_context
    prog = compile_hemm(legacy_context(eng, keys), plan, level=ctA.level,
                        schedule=schedule, rotation_chunk=rotation_chunk,
                        batched=batched)
    return prog(ctA, ctB)


# ---------------------------------------------------------------------------
# baselines (§VI-A)
# ---------------------------------------------------------------------------


def _pad(X: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols), dtype=np.float64)
    out[: X.shape[0], : X.shape[1]] = X
    return out


@dataclasses.dataclass
class BaselineRun:
    """A baseline = (shape padding rule, HLT schedule)."""
    name: str
    pad_shape: tuple          # (m', l', n') actually multiplied
    schedule: str


def baseline_spec(name: str, m: int, l: int, n: int) -> BaselineRun:
    if name == "e2dm-s":
        s = max(m, l, n)
        return BaselineRun(name, (s, s, s), "baseline")
    if name == "e2dm-r":
        if n <= l:
            return BaselineRun(name, (m, l, l), "baseline")
        if m <= l:
            return BaselineRun(name, (l, l, n), "baseline")
        s = max(m, l, n)
        return BaselineRun(name, (s, s, s), "baseline")
    if name == "huang":
        return BaselineRun(name, (m, l, n), "baseline")   # general, unhoisted
    if name == "hegmm-en":
        return BaselineRun(name, (m, l, n), "hoisted")
    raise ValueError(name)


def hemm_baseline(eng: CkksEngine, name: str, A: np.ndarray, B: np.ndarray,
                  keys_factory, rng: np.random.Generator):
    """Run a baseline end to end: ``keys_factory(rot_steps) -> Keys`` (each
    baseline gets exactly the rotation keys its plan needs).  Returns the
    decrypted m×n product and the plan of the padded shape."""
    from repro_torch.core.compile import HEContext, compile_hemm
    m, l, n = A.shape[0], A.shape[1], B.shape[1]
    spec = baseline_spec(name, m, l, n)
    mp, lp, np_ = spec.pad_shape
    plan = plan_hemm(eng, mp, lp, np_)
    ctx = HEContext(eng, keys_factory(plan.rot_steps))
    ctA = encrypt_matrix(eng, ctx.keys, _pad(A, mp, lp), rng)
    ctB = encrypt_matrix(eng, ctx.keys, _pad(B, lp, np_), rng)
    ct = compile_hemm(ctx, plan, schedule=spec.schedule)(ctA, ctB)
    return decrypt_matrix(eng, ctx.keys, ct, mp, np_)[:m, :n], plan
