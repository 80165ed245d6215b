"""Collective statistics and roofline terms of a counted run —
counterpart of ``repro/distributed/hlo_analysis.py``.

The port has no HLO: ``collective_stats`` reads the collectives that
``distributed/collectives.py`` recorded over a window (``collectives.
scope``: kind, the bytes recorded, the group's ranks) where the
reference parses the optimized HLO text.  A collective's bytes are those
a rank sends under a ring schedule: an all-reduce (a sum or a maximum;
the port's reduce-scatter is one) 2·(n−1)/n of the tensor it
contributes, an all-gather (n−1)/n of the tensor it assembles
(``link_bytes``).  The reference's jaxpr walk (the verifier's JX pass)
has its counterpart in ``analysis/census.py`` and is not repeated here.

``HW`` holds one NVIDIA H100 SXM 80GB's data-sheet terms (the card the
smoke runs on: NVIDIA H100 80GB HBM3, 700 W): ``roofline_terms`` divides
a count by them, so the seconds it returns are data-sheet terms, not
measurements.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

#: the reference's collective op names, by the kinds
#: ``distributed/collectives.py`` records (a barrier moves no bytes)
COLLECTIVE_OPS = {"all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
                  "reduce_scatter": "reduce-scatter",
                  "all_gather": "all-gather"}


def link_bytes(kind: str, nbytes: int, ranks: int) -> float:
    """The bytes a rank sends for one collective under a ring schedule:
    ``nbytes`` is what ``collectives`` records (the tensor contributed,
    or for an all-gather the tensor assembled) over ``ranks`` ranks."""
    if ranks <= 1 or kind not in COLLECTIVE_OPS:
        return 0.0
    if kind == "all_gather":
        return nbytes * (ranks - 1) / ranks
    return 2.0 * nbytes * (ranks - 1) / ranks


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: float
    by_op: dict
    count: int
    largest: list       # [(bytes, op, description)]


def collective_stats(trace) -> CollectiveStats:
    """Total, by op and the 12 largest of a window's collectives:
    ``trace`` is the list of (kind, bytes, ranks) that
    ``collectives.scope()`` filled."""
    by_op: dict = defaultdict(float)
    count = 0
    largest: list = []
    for kind, nbytes, ranks in trace:
        op = COLLECTIVE_OPS.get(kind)
        if op is None:
            continue
        b = link_bytes(kind, nbytes, ranks)
        by_op[op] += b
        count += 1
        largest.append((b, op, f"{kind} of {nbytes} B over {ranks} ranks"))
    largest.sort(reverse=True)
    return CollectiveStats(total_bytes=sum(by_op.values()), by_op=dict(by_op),
                           count=count, largest=largest[:12])


# --- hardware model: one H100 SXM 80GB, NVIDIA's data sheet -----------------

HW = {
    "peak_flops_bf16": 989e12,     # dense bf16 tensor-core FLOP/s a card
    "hbm_bw": 3.35e12,             # HBM3 bytes/s a card
    "ici_bw": 450e9,               # NVLink 4 bytes/s a direction
    "int32_ops": 67e12,            # 32-bit ops/s outside the tensor cores
}


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int, peak_flops: float = HW["peak_flops_bf16"]):
    """Per-card roofline terms in seconds (totals divided across cards)."""
    return {
        "compute_s": flops / (chips * peak_flops),
        "memory_s": hbm_bytes / (chips * HW["hbm_bw"]),
        "collective_s": coll_bytes / (chips * HW["ici_bw"]),
    }


def dominant_term(terms: dict) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])
