"""decode_mfu: a decode step's least time on the chip
(``costs/granite_hybrid.py``: its weights, state, cache and logits moved
once at the HBM peak, or its FLOPs at the dense bfloat16 peak, whichever
is longer) times the traced requests that were not profiled, over their
host seconds, in %; None without such requests or without a step's least
time."""


def read(rec):
    if not rec.spans or rec.spans_s <= 0 or "step" not in rec.least:
        return None
    return rec.least["step"] * len(rec.spans) / rec.spans_s * 100
