"""Device dispatch for the port's kernels, and the fused pipelines built on
them — counterpart of ``repro/kernels/ops.py`` (every one of its entry
points; ``kernels/ref.py`` holds the plain oracles) plus the pipelines of
``repro/kernels/basechange.py`` (``hoist_fused``, ``hoist_fused_db``,
``moddown_fused``).

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version.  There is no other path: a CUDA launch that fails
raises, and nothing falls back to the plain version.

``CALLS`` counts the calls of each entry point on any device (the
kernels' ``LAUNCHES`` count only CUDA launches): the verifier's census
reads it (rule JX002, ``analysis/census.py``).
"""
from __future__ import annotations

import functools

import torch.nn.functional as F

from repro_torch.kernels import basechange as _bc
from repro_torch.kernels import baseconv as _bcv
from repro_torch.kernels import fused_hlt as _fh
from repro_torch.kernels import modmul as _mm
from repro_torch.kernels import ntt as _ntt

_COUNTERS = (_fh.LAUNCHES, _bc.LAUNCHES, _ntt.LAUNCHES, _mm.LAUNCHES,
             _bcv.LAUNCHES)

#: calls of each kernel entry point, on any device
CALLS: dict = {}


def _entry(fn):
    CALLS[fn.__name__] = 0

    @functools.wraps(fn)
    def call(*args, **kwargs):
        CALLS[fn.__name__] += 1
        return fn(*args, **kwargs)
    return call


@_entry
def modmul(x, y, q32, qneg):
    fn = _mm.modmul_cuda if x.is_cuda else _mm.modmul_plain
    return fn(x, y, q32, qneg)


@_entry
def modadd(x, y, q32):
    fn = _mm.modadd_cuda if x.is_cuda else _mm.modadd_plain
    return fn(x, y, q32)


@_entry
def baseconv(x, hat_inv_m, q_own, qneg_own, W_m, D_mod_m, inv_d, q_gen,
             qneg_gen):
    fn = _bcv.baseconv_cuda if x.is_cuda else _bcv.baseconv_plain
    return fn(x, hat_inv_m, q_own, qneg_own, W_m, D_mod_m, inv_d, q_gen,
              qneg_gen)


@_entry
def ntt(x, psi_m, q32, qneg):
    fn = _ntt.ntt_cuda if x.is_cuda else _ntt.ntt_plain
    return fn(x, psi_m, q32, qneg)


@_entry
def intt(x, psii_m, ninv_m, q32, qneg):
    fn = _ntt.intt_cuda if x.is_cuda else _ntt.intt_plain
    return fn(x, psii_m, ninv_m, q32, qneg)


@_entry
def intt_scale(x, psii_m, ninv_m, scale_m, q32, qneg):
    if x.is_cuda:
        return _bc.intt_scale_cuda(x, psii_m, ninv_m, scale_m, q32, qneg)
    return _bc.intt_scale_plain(x, psii_m, ninv_m, scale_m, q32, qneg)


@_entry
def baseconv_ntt(y, w, d, inv_d, psi_m, q32, qneg, passthrough, mask):
    fn = _bc.baseconv_ntt_cuda if y.is_cuda else _bc.baseconv_ntt_plain
    return fn(y, w, d, inv_d, psi_m, q32, qneg, passthrough, mask)


@_entry
def hoist_db(c1s, *tables, nbeta: int, alpha: int):
    fn = _bc.hoist_db_cuda if c1s.is_cuda else _bc.hoist_db_plain
    return fn(c1s, *tables, nbeta=nbeta, alpha=alpha)


@_entry
def moddown_finish(x, y_drop, w, d, inv_d, psi_m, p_inv_m, q32, qneg):
    fn = _bc.moddown_finish_cuda if x.is_cuda else _bc.moddown_finish_plain
    return fn(x, y_drop, w, d, inv_d, psi_m, p_inv_m, q32, qneg)


@_entry
def fused_hlt_indexed(digits, c0e, c1e, u, rk0, rk1, perms, is_id, ct_slots,
                      diag_slots, q32, qneg):
    fn = (_fh.fused_hlt_indexed_cuda if digits.is_cuda
          else _fh.fused_hlt_indexed_plain)
    return fn(digits, c0e, c1e, u, rk0, rk1, perms, is_id, ct_slots,
              diag_slots, q32, qneg)


@_entry
def fused_hlt(digits, c0e, c1e, u, rk0, rk1, perms, is_id, q32, qneg):
    fn = _fh.fused_hlt_cuda if digits.is_cuda else _fh.fused_hlt_plain
    return fn(digits, c0e, c1e, u, rk0, rk1, perms, is_id, q32, qneg)


@_entry
def fused_hlt_batched(digits, c0e, c1e, u, rk0, rk1, perms, is_id, q32, qneg):
    fn = (_fh.fused_hlt_batched_cuda if digits.is_cuda
          else _fh.fused_hlt_batched_plain)
    return fn(digits, c0e, c1e, u, rk0, rk1, perms, is_id, q32, qneg)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    out: dict = {}
    for counts in _COUNTERS:
        out.update(counts)
    return out


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# fused pipelines
# ---------------------------------------------------------------------------


def hoist_fused(c1, t: dict):
    """Single fused hoist: c1 (nq, N) eval-domain main limbs -> digits
    (nbeta, M, N); one intt_scale launch over the digit rows zero-padded
    to nbeta·alpha, then one baseconv_ntt launch, the own rows passed
    through from c1 zero-padded to M rows (the reference's operands)."""
    nq = c1.shape[0]
    R, M = t["psii_pad"].shape[0], t["psi_full"].shape[0]
    y = intt_scale(F.pad(c1, (0, 0, 0, R - nq)), t["psii_pad"], t["ninv_pad"],
                   t["hat_pad"], t["q_pad"], t["qneg_pad"])
    return baseconv_ntt(y, t["w"], t["d"], t["inv_d"], t["psi_full"],
                        t["q_full"], t["qneg_full"],
                        F.pad(c1, (0, 0, 0, M - nq)), t["mask"])


def hoist_fused_db(c1s, t: dict):
    """Batched fused hoist: c1s (B, nq, N) eval-domain main limbs ->
    digits (B, nbeta, M, N), own rows passed through."""
    return hoist_db(c1s, t["psii_pad"], t["ninv_pad"], t["hat_pad"],
                    t["q_pad"], t["qneg_pad"], t["w"], t["d"], t["inv_d"],
                    t["psi_full"], t["q_full"], t["qneg_full"], t["mask"],
                    nbeta=t["nbeta"], alpha=t["alpha"])


def moddown_fused(x_full, t: dict):
    """Merged ModDown+Rescale over a batch: x_full (P, nq+k, N) eval-domain
    extended limbs at level ℓ -> (P, ℓ, N) over Q_{ℓ-1}; one intt_scale and
    one moddown_finish launch for all P polynomials.  On CUDA the
    intt_scale kernel reads the drop rows of x_full in place through the
    row table ``drop_idx``; the plain version gathers them."""
    tabs = (t["psii_drop"], t["ninv_drop"], t["hat_drop"], t["q_drop"],
            t["qneg_drop"])
    if x_full.is_cuda:
        y = _bc.intt_scale_rows_cuda(x_full, t["drop_idx"], *tabs)
    else:
        y = _bc.intt_scale_plain(x_full[:, t["drop_idx"]], *tabs)
    return moddown_finish(x_full[:, :t["n_out"]], y, t["w"], t["d"],
                          t["inv_d"], t["psi_out"], t["p_inv"], t["q_out"],
                          t["qneg_out"])
