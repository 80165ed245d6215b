"""request_mfu: a request's least time on the chip (``costs``: its inputs,
diagonals, keys and output moved once at the HBM peak, or its modular
products at the 32-bit peak) times the traced requests that were not
profiled, over their host seconds, in %."""


def read(rec):
    if not rec.spans or rec.spans_s <= 0:
        return None
    return rec.least["request"] * len(rec.spans) / rec.spans_s * 100
