"""Shared arithmetic of the span metrics (``metrics/*_ms``, ``*_roofline``)."""


def mean_ms(rec, span: str):
    """The span's mean ms over the traced requests that were not profiled,
    or None in an untraced run."""
    got = [s[span] for s in rec.spans if span in s]
    return sum(got) / len(got) * 1e3 if got else None


def roofline(rec, span: str):
    """The span's least time, times the profiled requests, over the
    device-busy time inside its ranges, in %; None without device events."""
    tr = rec.trace
    if tr is None or span not in rec.least:
        return None
    busy_s = tr.busy_in(span) / 1e6
    if busy_s <= 0:
        return None
    return rec.least[span] * rec.profiled / busy_s * 100
