"""The plain reference of an encrypted chain of matrix products, and its
control.

The reference of request i is X_i·W1·W2·…·Wk in float64, from the same
inputs that were encrypted for the program, and X_i·W1 for the first
hop's output.  The chain's output is judged as a hemm's answer is
(``reference/hemm.py`` ``Judge``: undecodable answers, the worst median
and the worst trimmed mean of |Y − X·W1·…·Wk|) over the entries outside
the first ``BIAS_ROWS`` rows, and the first hop's by its median
(``Judge``).

``control`` is the reference put in the program's place one precision
down: X and every W rounded to bfloat16 and the products taken in
bfloat16 (float32 accumulation), each hop's result rounded to bfloat16.
"""
from __future__ import annotations

import torch

from reference import hemm as ref_hemm

NUMBERS = ref_hemm.NUMBERS + ("worst_hop1_median_err",)

#: the rows of a chain's output that the floor rescaling's bias gathers in.
#: Each hop's bias gathers in slots 0-2 of its output, the entries
#: (0..2, 0) of the column-major layout (``reference/hemm.py``), and a
#: later hop computes row r of its output from row r of its input alone.
BIAS_ROWS = 3


class Judge(ref_hemm.Judge):
    """A hemm's numbers of the chain's output over the entries of rows
    ``BIAS_ROWS`` on, and ``worst_hop1_median_err``: the largest, over the
    answers, of the median |Y1 − X·W1| of the first hop's output.

    Leaving out rows 0-2 takes most of the entries that sit far off (at
    three hops 3-83 of an answer over 0.05 off, up to 0.73, their count
    swinging by seed; 1-27 outside rows 0-2), which the trimmed mean would
    follow.  The first hop's median holds the scheme's noise before two
    more hops add theirs: there it is 1/6 of a bfloat16 computation's, at
    the chain's output 1/2.6.  An answer fails when it is undecodable, or
    its output's median or its first hop's median is over its limit."""

    def __init__(self, limits: dict):
        super().__init__(limits)
        self.worst_hop1 = 0.0

    def add(self, C, want, C1=None, want1=None) -> None:
        """One answer: ``C`` the decoded output and ``C1`` the first hop's
        (None if undecodable), ``want`` and ``want1`` the reference's."""
        failed = self.failed
        super().add(None if C is None else C[BIAS_ROWS:], want[BIAS_ROWS:])
        if C1 is None:
            self.undecodable += C is not None
            self.failed = failed + 1
            return
        med = float((C1.to("cpu", torch.float64) - want1).abs().flatten()
                    .quantile(0.5))
        self.worst_hop1 = max(self.worst_hop1, med)
        if med > self.limits["worst_hop1_median_err"]:
            self.failed = failed + 1

    def numbers(self) -> dict:
        return dict(super().numbers(), worst_hop1_median_err=self.worst_hop1)

    def correct(self) -> bool:
        got = self.numbers()
        return self.count > 0 and all(got[k] <= self.limits[k]
                                      for k in NUMBERS)


def product(X, Ws):
    """X·W1·…·Wk in float64."""
    y = torch.as_tensor(X, dtype=torch.float64)
    for W in Ws:
        y = y @ torch.as_tensor(W, dtype=torch.float64)
    return y


def control(X, Ws, device):
    """X·W1·…·Wk in bfloat16 on ``device``, as float64."""
    def bf(a):
        return torch.as_tensor(a, dtype=torch.float64).to(device,
                                                          torch.bfloat16)
    y = bf(X)
    for W in Ws:
        y = y @ bf(W)
    return y.to(torch.float64).cpu()
