"""RNS basis management: BaseConv (HPS fast base conversion with a float64
floor correction), ModUp, ModDown, Rescale — counterpart of
``repro/core/rns.py``.

All polynomials here are in the COEFFICIENT domain, shape (|S|, N) int32.
Basis arguments S, T are tuples of global prime indices into
``ctx.moduli_host`` ([q_0..q_L, p_0..p_{k-1}]).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import modmath as mm, trace
from repro_torch.core.params import PrimeContext

#: floor correction of ``base_conv`` (the reference's ``+ 1e-9``, f64)
BASE_CONV_EPS = 1e-9

#: products of residues summed in int64 before one reduction: each is
#: below 2^60 (every modulus is below 2^30), so 7 stay below 2^63
BASE_CONV_GROUP = 7


class RnsTools:
    """Per-context cache of base-conversion / rescale / moddown tables
    (numpy on the host; converted to the context's device at use)."""

    def __init__(self, ctx: PrimeContext):
        self.ctx = ctx
        self._bc_cache: dict = {}
        self._scale_cache: dict = {}
        self._dev_cache: dict = {}

    # -- BaseConv ----------------------------------------------------------

    def _bc_tables(self, S: tuple, T: tuple):
        """(hat_inv (|S|,1) u32, W (|T|,|S|) u64, D mod t (|T|,1) u64,
        inv_d (|S|,1) f64) — numpy, as the reference's."""
        key = (S, T)
        if key not in self._bc_cache:
            qs = [self.ctx.moduli_host[i] for i in S]
            qt = [self.ctx.moduli_host[i] for i in T]
            D = 1
            for q in qs:
                D *= q
            hat = [D // q for q in qs]
            hat_inv = np.array([mm.host_inv(h % q, q)
                                for h, q in zip(hat, qs, strict=True)],
                               dtype=np.uint32)[:, None]
            W = np.array([[h % t for t in qt] for h in hat], dtype=np.uint64).T
            D_mod_t = np.array([D % t for t in qt], dtype=np.uint64)[:, None]
            inv_d = np.array([1.0 / q for q in qs])[:, None]
            self._bc_cache[key] = (hat_inv, W, D_mod_t, inv_d)
        return self._bc_cache[key]

    def _bc_device(self, S: tuple, T: tuple):
        key = ("bc", S, T)
        if key not in self._dev_cache:
            hat_inv, W, D_mod_t, inv_d = self._bc_tables(S, T)
            dev = self.ctx.device
            trace.h2d(6)
            self._dev_cache[key] = (
                torch.as_tensor(hat_inv.astype(np.int64), device=dev),
                torch.as_tensor(W.astype(np.int64), device=dev),
                torch.as_tensor(D_mod_t.astype(np.int64), device=dev),
                torch.as_tensor(inv_d, dtype=torch.float64, device=dev),
                self.ctx.moduli[torch.as_tensor(S, device=dev)],
                self.ctx.moduli[torch.as_tensor(T, device=dev)])
        return self._dev_cache[key]

    def base_conv(self, x, S: tuple, T: tuple):
        """Exact base conversion of the [0, D) representative.

        x: (..., |S|, N) residues over S, any leading (batch) dimensions.
        Returns (..., |T|, N) int32 residues over T.  The overflow count
        v = floor(Σ y_i/d_i + 1e-9) is summed in float64 in ascending row
        order for each coefficient.  Σ_i y_i·W_ti runs over the source rows
        in place, reduced mod t once every ``BASE_CONV_GROUP`` rows, so no
        (|T|, |S|, N) product is held."""
        hat_inv, W, D_mod_t, inv_d, qs, qt = self._bc_device(S, T)
        y = mm.mulmod(x, hat_inv, qs).to(torch.int64)     # (..., |S|, N)
        s = y[..., 0, :].to(torch.float64) * inv_d[0]
        for i in range(1, y.shape[-2]):
            s = s + y[..., i, :].to(torch.float64) * inv_d[i]
        v = torch.floor(s + BASE_CONV_EPS).to(torch.int64)   # (..., N)
        acc = None
        for g in range(0, y.shape[-2], BASE_CONV_GROUP):
            part = y[..., g:g + 1, :] * W[:, g:g + 1]
            for i in range(g + 1, min(g + BASE_CONV_GROUP, y.shape[-2])):
                part.addcmul_(y[..., i:i + 1, :], W[:, i:i + 1])
            part.remainder_(qt)
            acc = part if acc is None else acc.add_(part)
        del part
        corr = (v[..., None, :] * D_mod_t).remainder_(qt)
        return acc.remainder_(qt).add_(qt).sub_(corr).remainder_(qt).to(
            torch.int32)

    def mod_up(self, digit_coeff, S: tuple, T_new: tuple):
        """Raise a digit (coeff domain) from basis S: the generated limbs
        over T_new only."""
        return self.base_conv(digit_coeff, S, T_new)

    # -- ModDown / Rescale -------------------------------------------------

    def _moddown_tables(self, P: tuple, Q: tuple):
        """P^-1 mod q for q in Q, (|Q|, 1) uint32 numpy."""
        key = ("md", P, Q)
        if key not in self._scale_cache:
            Pprod = 1
            for i in P:
                Pprod *= self.ctx.moduli_host[i]
            qs = [self.ctx.moduli_host[i] for i in Q]
            self._scale_cache[key] = np.array(
                [mm.host_inv(Pprod % q, q) for q in qs], dtype=np.uint32)[:, None]
        return self._scale_cache[key]

    def mod_down(self, x_q, x_p, P: tuple, Q: tuple):
        """(x − [x]_P)/P: x_q (|Q|, N) and x_p (|P|, N) coefficient-domain
        residues.  Returns (|Q|, N)."""
        conv = self.base_conv(x_p, P, Q)
        trace.h2d()
        qs = self.ctx.moduli[torch.as_tensor(Q, device=self.ctx.device)]
        return mm.mulmod(mm.submod(x_q, conv, qs), self.moddown_pinv(P, Q), qs)

    def rescale(self, x, ell: int):
        """Drop limb q_ℓ: x (ℓ+1, N) coefficient domain -> (ℓ, N); ModDown
        with P = {q_ℓ}."""
        return self.mod_down(x[:ell], x[ell:ell + 1], (ell,), tuple(range(ell)))

    def moddown_pinv(self, P: tuple, Q: tuple) -> torch.Tensor:
        key = ("md", P, Q)
        if key not in self._dev_cache:
            trace.h2d()
            self._dev_cache[key] = torch.as_tensor(
                self._moddown_tables(P, Q).astype(np.int64),
                device=self.ctx.device)
        return self._dev_cache[key]

    # -- digit split -------------------------------------------------------

    def digit_bases(self, ell: int):
        """[(digit_prime_indices, generated_prime_indices, full)] at level ell."""
        p = self.ctx.params
        full = tuple(range(ell + 1)) + tuple(range(p.num_main, p.num_total))
        out = []
        for (s, e) in p.digits_at_level(ell):
            own = tuple(range(s, e))
            gen = tuple(i for i in full if not (s <= i < e))
            out.append((own, gen, full))
        return out
