"""The plain reference of an encrypted matrix product, and its comparison.

The reference of request i is A_i·B_i in float64, from the same inputs
that were encrypted for the program.  What the program returned is decoded
(``ckks.Decryptor``) and three numbers are held to limits of the cell's
file:

- ``undecodable``: answers that decrypt to no small message (limit 0);
- ``worst_median_err``: the largest, over the answers, of an answer's
  median |C − A·B| over its entries;
- ``worst_trimmed_err``: the largest, over the answers, of an answer's
  mean |C − A·B| over all its entries but the ``TRIM`` share that lie
  farthest off.  A fault confined to fewer than half of the entries, such
  as one wrong row of C, moves it where it leaves the median alone.

The mean and the largest |C − A·B| over all entries, and the most entries
of one answer that lie more than ``FAR`` off, are kept but not compared: a
few entries (slots 0, 1, 2, where the floor rescaling's bias gathers)
carry gaps of 0.05–0.75 whose size swings from seed to seed, so those
numbers read the widest gaps, and the control reads its largest gap below
the program's.  ``TRIM`` leaves out more entries than those few and fewer
than a row of the smallest cell.

``control`` is the reference put in the program's place one precision
down: A and B rounded to bfloat16 and multiplied in bfloat16 (float32
accumulation), the product rounded to bfloat16.
"""
from __future__ import annotations

import torch

NUMBERS = ("undecodable", "worst_median_err", "worst_trimmed_err")

#: the share of an answer's entries, farthest off first, that the trimmed
#: mean leaves out
TRIM = 0.002
#: the gap beyond which an entry counts as far off (not compared)
FAR = 0.05


def product(A, B):
    """A·B in float64."""
    return torch.as_tensor(A, dtype=torch.float64) @ torch.as_tensor(
        B, dtype=torch.float64)


def control(A, B, device):
    """A·B in bfloat16 on ``device``, as float64."""
    a = torch.as_tensor(A, dtype=torch.float64).to(device, torch.bfloat16)
    b = torch.as_tensor(B, dtype=torch.float64).to(device, torch.bfloat16)
    return (a @ b).to(torch.float64).cpu()


def as_matrix(slots, m: int, n: int):
    """The m×n matrix held column-major in the first m·n slots."""
    return slots[: m * n].reshape(n, m).T


class Judge:
    """Accumulates the numbers over answers; ``failed`` counts the answers
    that are undecodable or whose median error is over the limit."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.undecodable = 0
        self.failed = 0
        self.count = 0
        self.max_err = 0.0
        self.sum_err = 0.0
        self.worst_median = 0.0
        self.worst_trimmed = 0.0
        self.worst_far = 0
        self.entries = 0

    def add(self, C, want) -> None:
        """One answer: ``C`` the decoded matrix (None if undecodable),
        ``want`` the reference's."""
        self.count += 1
        if C is None:
            self.undecodable += 1
            self.failed += 1
            return
        err = (C.to("cpu", torch.float64) - want).abs().flatten()
        median = float(err.quantile(0.5))
        kept = err.numel() - int(TRIM * err.numel())
        trimmed = float(err.sort().values[:kept].mean())
        self.worst_median = max(self.worst_median, median)
        self.worst_trimmed = max(self.worst_trimmed, trimmed)
        self.worst_far = max(self.worst_far, int((err > FAR).sum()))
        self.max_err = max(self.max_err, float(err.max()))
        self.sum_err += float(err.sum())
        self.entries += err.numel()
        if (median > self.limits["worst_median_err"]
                or trimmed > self.limits["worst_trimmed_err"]):
            self.failed += 1

    def numbers(self) -> dict:
        return {"undecodable": self.undecodable,
                "worst_median_err": self.worst_median,
                "worst_trimmed_err": self.worst_trimmed}

    def not_compared(self) -> dict:
        return {"mean_abs_err": self.sum_err / max(self.entries, 1),
                "max_abs_err": self.max_err,
                "worst_far_entries": self.worst_far}

    def correct(self) -> bool:
        got = self.numbers()
        return self.count > 0 and all(got[k] <= self.limits[k]
                                      for k in NUMBERS)
