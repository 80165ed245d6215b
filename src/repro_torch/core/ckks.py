"""CKKS (RNS variant): encode/decode, keygen, encrypt/decrypt, add, sub,
cmult, mod_drop, mult with hybrid (β-digit) keyswitching, rotate, rescale —
counterpart of ``repro/core/ckks.py``.

Conventions are the reference's: ct = (c0, c1), dec(ct) = c0 + c1·s
(mod Q_ℓ); polynomials are (ℓ+1, N) int32 limbs in bit-reversed
evaluation domain; prime order [q_0 .. q_L, p_0 .. p_{k-1}]; scales are
host floats.  Randomness comes from a numpy ``Generator`` drawn in the
reference's exact order, so the same seed gives array-equal keys and
ciphertexts.

``datapath`` picks the lowering of the engine's own transforms (encode,
decode, keygen, the keyswitch inside ``mult`` / ``rotate`` and its
ModDown, ``rescale``, the merged ModDown+Rescale of ``_mod_down_eval``),
as the reference's knob does: ``"xla"`` (the default) keeps
them on the plain int64 NTT, the counterpart of the reference's u64 XLA
lowering; ``"pallas"`` runs them through the ``ntt`` / ``intt`` kernels
(``kernels/ntt.py``; the plain Montgomery versions on the CPU).  Both give
the same residues.  The HLT's fused stages run on the kernels either way
(``core/hlt.py``, ``core/compile.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import automorph, modmath as mm, ntt, trace
from repro_torch.core.params import HEParams, PrimeContext, get_context
from repro_torch.core.rns import RnsTools
from repro_torch.kernels import basechange, ops

DATAPATHS = ("xla", "pallas")


def resolve_device(device) -> torch.device:
    """``None`` means the GPU.  Raises when CUDA is asked for and absent:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch path explicitly")
    return dev


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ciphertext:
    """One ciphertext, or a batch of B of one level (``c0``/``c1`` then
    (B, level+1, N)) that the engine's ``mult``, ``key_switch``,
    ``rescale``, ``add`` and ``sum`` run as one; a batch carries one
    scale, so a caller whose elements differ in scale keeps theirs."""
    c0: torch.Tensor          # (level+1, N) int32, eval domain
    c1: torch.Tensor
    level: int
    scale: float


@dataclasses.dataclass
class Plaintext:
    data: torch.Tensor        # (level+1, N) int32, eval domain
    level: int
    scale: float


@dataclasses.dataclass
class EvalKey:
    """Hybrid keyswitching key: digit-stacked rows over the FULL basis."""
    k0: torch.Tensor          # (beta, M, N) int32 eval
    k1: torch.Tensor


@dataclasses.dataclass
class Keys:
    s_eval: torch.Tensor                # (M, N) secret over the full basis
    evk_mult: EvalKey
    rot: dict                           # step -> key
    galois: dict                        # galois element -> key (same objects)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _rows3(fn, x, *tables):
    """A (B, M, N) kernel on x of shape (..., M, N): the leading dimensions
    flattened into B (a view for a strided row slice of a batch)."""
    out = fn(x.reshape((-1,) + tuple(x.shape[-2:])), *tables)
    return out.reshape(tuple(x.shape[:-2]) + tuple(out.shape[-2:]))


class CkksEngine:
    """CKKS engine on one device (``None`` = CUDA; raises without a GPU);
    ``datapath`` selects the (i)NTT lowering of every transform it runs."""

    def __init__(self, params: HEParams, device=None, datapath: str = "xla"):
        if datapath not in DATAPATHS:
            raise ValueError(f"datapath={datapath!r} not in {DATAPATHS}")
        self.params = params
        self.datapath = datapath
        self.device = resolve_device(device)
        self.ctx: PrimeContext = get_context(params, self.device)
        self.tools = RnsTools(self.ctx)
        self._fused_tabs: dict = {}
        self._views: dict = {}
        self.op_counts: dict = {"encrypts": 0, "decrypts": 0}

    # -- basis helpers ------------------------------------------------------

    def basis(self, idx):
        key = tuple(int(i) for i in idx)
        if key not in self._views:
            self._views[key] = self.ctx.slc(np.asarray(key, dtype=np.int64))
        return self._views[key]

    def main_basis(self, ell: int):
        return self.basis(range(ell + 1))

    def _ntt(self, x, view):
        """Forward NTT of (..., M, N) rows over ``view``."""
        if self.datapath == "pallas":
            return _rows3(ops.ntt, x, view.psi_brv_mont, view.moduli_u32,
                          view.qneg_inv)
        return ntt.ntt(x, view.psi_brv, view.moduli)

    def _intt(self, x, view):
        """Inverse NTT of (..., M, N) rows over ``view``."""
        if self.datapath == "pallas":
            return _rows3(ops.intt, x, view.psi_inv_brv_mont,
                          view.n_inv_mont, view.moduli_u32, view.qneg_inv)
        return ntt.intt(x, view.psi_inv_brv, view.n_inv, view.moduli)

    # -- fused base-change tables (cached per level, float64 correction) -----

    def fused_hoist_tables(self, level: int) -> dict:
        key = ("hoist", level)
        if key not in self._fused_tabs:
            self._fused_tabs[key] = basechange.to_device(
                basechange.build_hoist_tables(self.ctx, self.tools, level),
                self.device)
        return self._fused_tabs[key]

    def fused_moddown_tables(self, level: int) -> dict:
        key = ("moddown", level)
        if key not in self._fused_tabs:
            self._fused_tabs[key] = basechange.to_device(
                basechange.build_moddown_tables(self.ctx, self.tools, level),
                self.device)
        return self._fused_tabs[key]

    # -- encode / decode (host FFT canonical embedding) ---------------------

    def _embed(self, m, scale: float) -> np.ndarray:
        """Rounded integer-valued float64 coefficients of message m."""
        p = self.params
        m = np.asarray(m, dtype=np.complex128).ravel()
        if m.size > p.slots:
            raise ValueError(f"message {m.size} > slots {p.slots}")
        mv = np.zeros(p.slots, dtype=np.complex128)
        mv[: m.size] = m
        spec = np.zeros(2 * p.N, dtype=np.complex128)
        spec[self.ctx.rot_group] = mv
        return np.round(np.fft.fft(spec)[: p.N].real * (2.0 / p.N) * scale)

    def encode(self, m, level: Optional[int] = None,
               scale: Optional[float] = None) -> Plaintext:
        p = self.params
        level = p.L if level is None else level
        scale = p.scale if scale is None else scale
        res = self._int_coeffs_to_basis(self._embed(m, scale),
                                        list(range(level + 1)))
        data = self._ntt(self._to_dev(res), self.main_basis(level))
        return Plaintext(data=data, level=level, scale=scale)

    def encode_to_basis(self, m, idx, scale: float) -> torch.Tensor:
        """Encode over an arbitrary prime basis (e.g. Q∪P for DiagIP
        plaintexts). Returns (|idx|, N) eval residues."""
        res = self._int_coeffs_to_basis(self._embed(m, scale), idx)
        return self._ntt(self._to_dev(res), self.basis(idx))

    def _int_coeffs_to_basis(self, coeffs, idx) -> np.ndarray:
        """Integer-valued float64 coefficients -> (|idx|, N) uint32 residues.

        The reference reduces Python ints one by one; int64 floor-mod is
        the same map while |coeff| < 2^63 (tests pin the equality)."""
        ints = np.asarray(coeffs, dtype=np.float64).astype(np.int64)
        qs = np.asarray([self.ctx.moduli_host[i] for i in idx],
                        np.int64)[:, None]
        return np.mod(ints[None, :], qs).astype(np.uint32)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        trace.h2d()
        return torch.from_numpy(
            np.ascontiguousarray(a, np.uint32).view(np.int32)).to(self.device)

    def _crt_lift_centered(self, limbs: np.ndarray, level: int) -> np.ndarray:
        """uint32 (level+1, N) -> centered python-int coefficients."""
        qs = [self.ctx.moduli_host[i] for i in range(level + 1)]
        Q = 1
        for q in qs:
            Q *= q
        acc = np.zeros(limbs.shape[1], dtype=object)
        for i, q in enumerate(qs):
            hat = Q // q
            w = hat * mm.host_inv(hat % q, q)
            acc = (acc + limbs[i].astype(object) * (w % Q)) % Q
        return np.where(acc > Q // 2, acc - Q, acc)

    def decode(self, pt: Plaintext, num: Optional[int] = None) -> np.ndarray:
        p = self.params
        coeff = self._intt(pt.data, self.main_basis(pt.level))
        limbs = coeff.cpu().numpy().astype(np.int64)
        c = self._crt_lift_centered(limbs, pt.level).astype(np.float64)
        vals = np.conj(np.fft.fft(c, 2 * p.N))[self.ctx.rot_group] / pt.scale
        return vals[: (num if num is not None else p.slots)]

    # -- sampling ------------------------------------------------------------

    def _small_poly_eval(self, ints: np.ndarray, idx) -> torch.Tensor:
        """The eval residues of integer coefficients ``ints`` over basis
        ``idx``, reduced on the device (one row crosses, not |idx|)."""
        view = self.basis(idx)
        x = torch.from_numpy(np.ascontiguousarray(ints, np.int64))
        trace.h2d()
        res = torch.remainder(x.to(self.device)[None, :], view.moduli)
        return self._ntt(res.to(torch.int32), view)

    def _uniform_poly(self, rng: np.random.Generator, idx) -> torch.Tensor:
        qs = np.array([self.ctx.moduli_host[i] for i in idx],
                      dtype=np.uint64)[:, None]
        return self._to_dev(rng.integers(0, qs, size=(len(idx), self.params.N))
                            .astype(np.uint32))

    # -- keygen ---------------------------------------------------------------

    def keygen(self, rng: np.random.Generator, rot_steps=()) -> Keys:
        p = self.params
        full = list(range(p.num_total))
        s_int = rng.integers(-1, 2, size=p.N).astype(np.int64)
        s_eval = self._small_poly_eval(s_int, full)
        view = self.basis(full)
        s2_eval = mm.mulmod(s_eval, s_eval, view.moduli)
        evk_mult = self._make_evk(rng, s_eval, s2_eval)
        rot, galois = {}, {}
        for r in rot_steps:
            g = automorph.galois_elt_rot(r, p.N)
            if g in galois:
                rot[r] = galois[g]
                continue
            s_rot = automorph.apply_eval(s_eval, p.N, g)
            k = self._make_evk(rng, s_eval, s_rot)
            rot[r] = k
            galois[g] = k
        return Keys(s_eval=s_eval, evk_mult=evk_mult, rot=rot, galois=galois)

    def _make_evk(self, rng: np.random.Generator, s_eval, sprime_eval) -> EvalKey:
        """evk_j = (-a_j s + e_j + W_j s', a_j) over the full basis, where
        W_j = P · [ D̂_j · (D̂_j^{-1} mod D_j) ]."""
        p = self.params
        full = list(range(p.num_total))
        q = self.basis(full).moduli
        Pprod = 1
        for i in range(p.num_main, p.num_total):
            Pprod *= self.ctx.moduli_host[i]
        QL = 1
        for i in range(p.num_main):
            QL *= self.ctx.moduli_host[i]
        digits = p.digits_at_level(p.L)
        k0 = torch.empty((len(digits), len(full), p.N), dtype=torch.int32,
                         device=self.device)
        k1 = torch.empty_like(k0)
        for j, (st, en) in enumerate(digits):
            Dj = 1
            for i in range(st, en):
                Dj *= self.ctx.moduli_host[i]
            hatDj = QL // Dj
            w_int = Pprod * hatDj * pow(hatDj % Dj, -1, Dj)
            trace.h2d()
            w_res = torch.tensor([w_int % self.ctx.moduli_host[i] for i in full],
                                 dtype=torch.int64, device=self.device)[:, None]
            a = self._uniform_poly(rng, full)
            e_eval = self._small_poly_eval(
                np.round(rng.normal(0, 3.2, size=p.N)).astype(np.int64), full)
            w_sp = mm.mulmod(sprime_eval, w_res, q)
            k0[j] = mm.addmod(mm.submod(e_eval, mm.mulmod(a, s_eval, q), q),
                              w_sp, q)
            k1[j] = a
        return EvalKey(k0=k0, k1=k1)

    # -- encrypt / decrypt ----------------------------------------------------

    def encrypt(self, pt: Plaintext, keys: Keys,
                rng: np.random.Generator) -> Ciphertext:
        self.op_counts["encrypts"] += 1
        idx = list(range(pt.level + 1))
        q = self.basis(idx).moduli
        a = self._uniform_poly(rng, idx)
        e = self._small_poly_eval(
            np.round(rng.normal(0, 3.2, size=self.params.N)).astype(np.int64), idx)
        c0 = mm.addmod(
            mm.submod(e, mm.mulmod(a, keys.s_eval[: pt.level + 1], q), q),
            pt.data, q)
        return Ciphertext(c0=c0, c1=a, level=pt.level, scale=pt.scale)

    def decrypt(self, ct: Ciphertext, keys: Keys) -> Plaintext:
        self.op_counts["decrypts"] += 1
        q = self.main_basis(ct.level).moduli
        data = mm.addmod(ct.c0, mm.mulmod(ct.c1, keys.s_eval[: ct.level + 1], q), q)
        return Plaintext(data=data, level=ct.level, scale=ct.scale)

    def decrypt_decode(self, ct: Ciphertext, keys: Keys, num=None) -> np.ndarray:
        return self.decode(self.decrypt(ct, keys), num)

    # -- homomorphic ops ------------------------------------------------------

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.level != b.level:
            raise ValueError(f"add needs equal levels, got {a.level}, {b.level}")
        q = self.main_basis(a.level).moduli
        return Ciphertext(mm.addmod(a.c0, b.c0, q), mm.addmod(a.c1, b.c1, q),
                          a.level, max(a.scale, b.scale))

    def sum(self, ct: Ciphertext) -> Ciphertext:
        """The modular sum of a batch's B ciphertexts: the residues of a
        chain of ``add`` calls in any order (the int64 sum of B terms below
        2^30 is exact and is reduced once)."""
        q = self.main_basis(ct.level).moduli
        return Ciphertext(mm.montsum(ct.c0, q), mm.montsum(ct.c1, q),
                          ct.level, ct.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        q = self.main_basis(a.level).moduli
        return Ciphertext(mm.submod(a.c0, b.c0, q), mm.submod(a.c1, b.c1, q),
                          a.level, max(a.scale, b.scale))

    def cmult(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        """ct × plaintext (no rescale)."""
        if pt.level < ct.level:
            raise ValueError(f"cmult: plaintext level {pt.level} below the "
                             f"ciphertext's {ct.level}")
        q = self.main_basis(ct.level).moduli
        d = pt.data[: ct.level + 1]
        return Ciphertext(mm.mulmod(ct.c0, d, q), mm.mulmod(ct.c1, d, q),
                          ct.level, ct.scale * pt.scale)

    def mod_drop(self, ct: Ciphertext, level: int) -> Ciphertext:
        """Drop limbs down to ``level`` (row views, no arithmetic)."""
        if level > ct.level:
            raise ValueError(f"mod_drop to level {level} above {ct.level}")
        return Ciphertext(ct.c0[: level + 1], ct.c1[: level + 1], level,
                          ct.scale)

    def mult(self, a: Ciphertext, b: Ciphertext, keys: Keys) -> Ciphertext:
        """ct × ct with relinearization (no rescale; call rescale() after);
        two batches of B multiply element by element."""
        if a.level != b.level:
            raise ValueError(f"mult needs equal levels, got {a.level}, {b.level}")
        ell = a.level
        q = self.main_basis(ell).moduli
        d0 = mm.mulmod(a.c0, b.c0, q)
        d1 = mm.addmod(mm.mulmod(a.c0, b.c1, q), mm.mulmod(a.c1, b.c0, q), q)
        d2 = mm.mulmod(a.c1, b.c1, q)
        k0, k1 = self.key_switch(d2, keys.evk_mult, ell)
        return Ciphertext(mm.addmod(d0, k0, q), mm.addmod(d1, k1, q),
                          ell, a.scale * b.scale)

    def rotate(self, ct: Ciphertext, r: int, keys: Keys) -> Ciphertext:
        """Rot(ct, r): circular left rotation of the slots by r (a full
        KeySwitch of the permuted c1)."""
        N = self.params.N
        g = automorph.galois_elt_rot(r, N)
        key = keys.galois.get(g) or keys.rot[r]
        c0p = automorph.apply_eval(ct.c0, N, g)
        c1p = automorph.apply_eval(ct.c1, N, g)
        k0, k1 = self.key_switch(c1p, key, ct.level)
        q = self.main_basis(ct.level).moduli
        return Ciphertext(mm.addmod(c0p, k0, q), k1, ct.level, ct.scale)

    # -- keyswitch (coarse-grained reference form) ---------------------------

    def key_switch(self, d, evk: EvalKey, ell: int):
        """d: (..., ell+1, N) eval-domain poly(s) under s'; returns (k0, k1)
        under s, each (..., ell+1, N).  Every row set it touches is a
        slice: a digit's own limbs [s, e) of Q_ℓ, its generated limbs the
        rest of Q_ℓ ∪ P in order, the key's Q_ℓ ∪ P rows its first ℓ+1 and
        its special rows; no host data crosses to the device."""
        with trace.span("he.key_switch"):
            bases = self.tools.digit_bases(ell)
            q = self.basis(bases[0][2]).moduli
            acc = [None, None]
            for j, (own, gen, _) in enumerate(bases):
                self._digit_product(acc, d, own, gen,
                                    (evk.k0[j], evk.k1[j]), ell, q)
            k0 = self._mod_down_eval(acc[0], ell)
            acc[0] = None
            return k0, self._mod_down_eval(acc[1], ell)

    def _digit_product(self, acc: list, d, own, gen, key, ell: int, q):
        """acc[i] = acc[i] + (digit ``own`` of d raised to Q_ℓ ∪ P) × key[i]
        rows mod q: the raised digit is its own rows [s, e) between the
        generated rows of Q_ℓ and P, in place; one int64 multiply-add and
        one reduction a key (the addmod of the mulmod: each term is below
        2^60); the temporaries die on return."""
        st, en = own[0], own[-1] + 1
        dig_eval = d[..., st:en, :]
        ext = self._ntt(self.tools.mod_up(
            self._intt(dig_eval, self.basis(own)), own, gen), self.basis(gen))
        x = torch.cat([ext[..., :st, :], dig_eval, ext[..., st:, :]],
                      dim=-2).to(torch.int64)
        del ext
        for i, k in enumerate(key):
            rows = self._key_rows(k, ell).to(torch.int64)
            t = (x * rows if acc[i] is None
                 else acc[i].to(torch.int64).addcmul_(x, rows))
            acc[i] = t.remainder_(q).to(torch.int32)
            del t

    def _key_rows(self, k, ell: int):
        """A key digit's (M, N) rows over the full basis -> its Q_ℓ ∪ P
        rows (two slices)."""
        p = self.params
        if ell == p.L:
            return k
        return torch.cat([k[: ell + 1], k[p.num_main:]])

    def _mod_down_eval(self, x_full, ell: int, drop_last: bool = False,
                       datapath: Optional[str] = None):
        """ModDown from Q_ℓ ∪ P back to Q_ℓ, or with ``drop_last`` to
        Q_{ℓ-1} (the merged ModDown+Rescale, P ∪ {q_ℓ} → Q_{ℓ-1}); eval
        domain in and out, (..., rows, N).  ``datapath`` overrides the
        engine's knob for this call: on ``"pallas"`` with ``drop_last`` the
        whole tail runs as ``intt_scale`` + ``moddown_finish``
        (``ops.moddown_fused``), as the reference's; otherwise the chain
        iNTT → BaseConv → NTT → subtract → × P⁻¹ runs on the engine's
        transforms."""
        dp = self.datapath if datapath is None else datapath
        if dp == "pallas" and drop_last:
            return _rows3(ops.moddown_fused, x_full,
                          self.fused_moddown_tables(ell))
        p = self.params
        spec = tuple(range(p.num_main, p.num_total))
        P = spec + ((ell,) if drop_last else ())
        Q = tuple(range(ell)) if drop_last else tuple(range(ell + 1))
        x_p = x_full[..., ell + 1:, :]
        if drop_last:
            x_p = torch.cat([x_p, x_full[..., ell:ell + 1, :]], dim=-2)
        qv = self.basis(Q)
        conv_eval = self._ntt(self.tools.base_conv(
            self._intt(x_p, self.basis(P)), P, Q), qv)
        return mm.mulmod(mm.submod(x_full[..., : len(Q), :], conv_eval,
                                   qv.moduli),
                         self.tools.moddown_pinv(P, Q), qv.moduli)

    # -- rescale ---------------------------------------------------------------

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Divide by q_ℓ, dropping one level (eval-domain single-limb path;
        a batch as one)."""
        with trace.span("he.rescale"):
            ell = ct.level
            q_ell = self.ctx.moduli_host[ell]
            return Ciphertext(self._rescale_poly(ct.c0, ell),
                              self._rescale_poly(ct.c1, ell), ell - 1,
                              ct.scale / q_ell)

    def _rescale_poly(self, x, ell: int):
        """(..., ℓ+1, N) eval rows -> (..., ℓ, N), divided by q_ℓ (floor)."""
        Q = tuple(range(ell))
        qv = self.main_basis(ell - 1)
        conv_eval = self._ntt(self.tools.base_conv(
            self._intt(x[..., ell:ell + 1, :], self.basis((ell,))), (ell,),
            Q), qv)
        return mm.mulmod(mm.submod(x[..., :ell, :], conv_eval, qv.moduli),
                         self.tools.moddown_pinv((ell,), Q), qv.moduli)
