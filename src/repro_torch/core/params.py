"""HE parameter sets (paper Table II) and precomputed prime/NTT contexts.

Counterpart of ``repro/core/params.py``.  The prime and twiddle tables are
rebuilt from numpy with the reference's fixed seed ``0xFA3E`` and are
byte-identical to it; :class:`PrimeContext` keeps them as numpy arrays
(``host``, for the table builders) and as torch tensors on one device.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch._guards import detect_fake_mode

from repro_torch.core import modmath as mm, trace


@dataclasses.dataclass(frozen=True)
class HEParams:
    """CKKS parameter set. L+1 main limbs q_0..q_L, k special limbs p_0..p_{k-1}."""

    name: str
    logN: int
    L: int
    k: int
    beta: int
    scale_bits: int = 28
    q0_bits: int = 29
    sp_bits: int = 30
    logq_paper: float = 54.0

    @property
    def N(self) -> int:
        return 1 << self.logN

    @property
    def two_n(self) -> int:
        return 2 << self.logN

    @property
    def slots(self) -> int:
        return self.N // 2

    @property
    def num_main(self) -> int:
        return self.L + 1

    @property
    def num_total(self) -> int:
        return self.L + 1 + self.k

    @property
    def alpha(self) -> int:
        return math.ceil((self.L + 1) / self.beta)

    @property
    def scale(self) -> float:
        return float(1 << self.scale_bits)

    def digits_at_level(self, ell: int) -> list[tuple[int, int]]:
        """Digit decomposition [start, end) limb ranges for a level-ell Ct."""
        nl = ell + 1
        out = []
        s = 0
        while s < nl:
            e = min(s + self.alpha, nl)
            out.append((s, e))
            s = e
        return out

    def validate(self) -> None:
        if not (self.L >= 1 and self.k >= 1 and 1 <= self.beta <= self.L + 1):
            raise ValueError(f"invalid HE parameters {self}")


SET_A = HEParams("Set-A", logN=13, L=4, k=1, beta=1, logq_paper=218 / 5)
SET_B = HEParams("Set-B", logN=15, L=15, k=8, beta=2, logq_paper=855 / 16)
SET_C = HEParams("Set-C", logN=16, L=31, k=12, beta=3, logq_paper=1693 / 32)

PAPER_SETS = {"set-a": SET_A, "set-b": SET_B, "set-c": SET_C}


def toy_params(logN: int = 6, L: int = 4, k: int = 2, beta: int = 2,
               scale_bits: int = 26, name: str = "toy") -> HEParams:
    """Small runnable parameter set for CPU tests (structure-faithful)."""
    return HEParams(name, logN=logN, L=L, k=k, beta=beta,
                    scale_bits=scale_bits, q0_bits=29, sp_bits=30)


# ---------------------------------------------------------------------------
# host tables (numpy, device-independent)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HostTables:
    """The reference's PrimeContext tables as numpy (uint32 unless noted)."""

    moduli: tuple                 # python ints, [q_0..q_L, p_0..p_{k-1}]
    qneg_inv: np.ndarray          # (M,)
    r2: np.ndarray                # (M,)
    psi_brv: np.ndarray           # (M, N)
    psi_inv_brv: np.ndarray
    psi_brv_mont: np.ndarray
    psi_inv_brv_mont: np.ndarray
    n_inv: np.ndarray             # (M,)
    n_inv_mont: np.ndarray        # (M,)
    rot_group: np.ndarray         # (slots,) int64: 5^j mod 2N


def _tables_for_prime(q: int, N: int, rng: np.random.Generator):
    psi = mm.find_primitive_root(q, 2 * N, rng)
    psi_inv = mm.host_inv(psi, q)
    brv = mm.bit_reverse_indices(N)
    pw = mm.host_powers(psi, N, q)[brv]
    pwi = mm.host_powers(psi_inv, N, q)[brv]
    return pw.astype(np.uint32), pwi.astype(np.uint32), mm.host_inv(N, q)


@functools.lru_cache(maxsize=None)
def host_tables(params: HEParams) -> HostTables:
    params.validate()
    N, two_n = params.N, params.two_n
    rng = np.random.default_rng(0xFA3E)
    specials = mm.gen_ntt_primes(params.k, params.sp_bits, two_n)
    skip = frozenset(specials)
    q0 = mm.gen_ntt_primes(1, params.q0_bits, two_n, skip=skip)
    skip = skip | frozenset(q0)
    scales = mm.gen_ntt_primes(params.L, params.scale_bits, two_n, skip=skip)
    moduli = tuple(q0 + scales + specials)
    assert len(set(moduli)) == len(moduli)

    M = len(moduli)
    psi = np.empty((M, N), np.uint32)
    psii = np.empty((M, N), np.uint32)
    ninv = np.empty((M,), np.uint32)
    ninv_m = np.empty((M,), np.uint32)
    qneg = np.empty((M,), np.uint32)
    r2 = np.empty((M,), np.uint32)
    for i, q in enumerate(moduli):
        psi[i], psii[i], n_inv = _tables_for_prime(q, N, rng)
        ninv[i] = n_inv
        qneg[i], r2[i] = mm.mont_constants(q)
        ninv_m[i] = (n_inv << 32) % q
    qcol = np.asarray(moduli, np.uint64)[:, None]
    rot_group = np.empty(params.slots, dtype=np.int64)
    g = 1
    for j in range(params.slots):
        rot_group[j] = g
        g = (g * 5) % two_n
    return HostTables(
        moduli=moduli, qneg_inv=qneg, r2=r2, psi_brv=psi, psi_inv_brv=psii,
        psi_brv_mont=mm.to_mont_host_arr(psi, qcol),
        psi_inv_brv_mont=mm.to_mont_host_arr(psii, qcol),
        n_inv=ninv, n_inv_mont=ninv_m, rot_group=rot_group)


# ---------------------------------------------------------------------------
# device context
# ---------------------------------------------------------------------------


def u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy -> int32 tensor holding the same bits, on ``device``."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with the same bits."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


@dataclasses.dataclass(frozen=True)
class PrimeContext:
    """Device-resident tables.  Prime order: [q_0 .. q_L, p_0 .. p_{k-1}].

    u32 tables are int32 tensors (same bits); ``moduli`` is the (M, 1)
    int64 column the reference arithmetic broadcasts against."""

    params: HEParams
    device: torch.device
    host: HostTables
    moduli: torch.Tensor            # (M, 1) int64
    moduli_u32: torch.Tensor        # (M, 1) int32
    qneg_inv: torch.Tensor          # (M, 1) int32 view of uint32
    r2: torch.Tensor                # (M, 1) int32
    psi_brv: torch.Tensor           # (M, N)
    psi_inv_brv: torch.Tensor
    psi_brv_mont: torch.Tensor
    psi_inv_brv_mont: torch.Tensor
    n_inv: torch.Tensor             # (M, 1)
    n_inv_mont: torch.Tensor        # (M, 1)

    @property
    def moduli_host(self) -> tuple:
        return self.host.moduli

    @property
    def rot_group(self) -> np.ndarray:
        return self.host.rot_group

    def slc(self, idx) -> "BasisView":
        return BasisView(self, np.asarray(idx, dtype=np.int64))


_VIEW_FIELDS = ("moduli", "moduli_u32", "qneg_inv", "r2", "psi_brv",
                "psi_inv_brv", "psi_brv_mont", "psi_inv_brv_mont", "n_inv",
                "n_inv_mont")


class BasisView:
    """Per-basis slices of a PrimeContext (a ciphertext's current moduli)."""

    def __init__(self, ctx: PrimeContext, idx: np.ndarray):
        self.ctx = ctx
        self.idx = idx
        trace.h2d()
        self._sel = torch.as_tensor(idx, dtype=torch.int64, device=ctx.device)
        self._cache: dict = {}

    @functools.cached_property
    def moduli_host(self) -> tuple:
        return tuple(self.ctx.moduli_host[i] for i in self.idx)

    def __getattr__(self, name):
        if name not in _VIEW_FIELDS:
            raise AttributeError(name)
        if name not in self._cache:
            self._cache[name] = getattr(self.ctx, name)[self._sel]
        return self._cache[name]

    def __len__(self) -> int:
        return len(self.idx)


@functools.lru_cache(maxsize=None)
def _context(params: HEParams, device: torch.device) -> PrimeContext:
    h = host_tables(params)
    col = lambda a: u32_tensor(np.asarray(a)[:, None], device)
    return PrimeContext(
        params=params, device=device, host=h,
        moduli=torch.tensor(h.moduli, dtype=torch.int64, device=device)[:, None],
        moduli_u32=col(np.asarray(h.moduli, np.uint32)),
        qneg_inv=col(h.qneg_inv), r2=col(h.r2),
        psi_brv=u32_tensor(h.psi_brv, device),
        psi_inv_brv=u32_tensor(h.psi_inv_brv, device),
        psi_brv_mont=u32_tensor(h.psi_brv_mont, device),
        psi_inv_brv_mont=u32_tensor(h.psi_inv_brv_mont, device),
        n_inv=col(h.n_inv), n_inv_mont=col(h.n_inv_mont))


def get_context(params: HEParams, device="cpu") -> PrimeContext:
    """The cached context of (params, device); under a ``FakeTensorMode``
    (the cost reports) a fresh one of fake tensors, kept out of the cache
    that real callers read."""
    if detect_fake_mode() is not None:
        return _context.__wrapped__(params, torch.device(device))
    return _context(params, torch.device(device))
