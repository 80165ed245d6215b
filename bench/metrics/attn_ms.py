"""attn_ms: ms a decode step spends in its attention mixer (span
``lm.attn``: the projections, the KV write, attention over the cache),
averaged over the traced requests that were not profiled, each span
synchronised at both ends; None where the program has no such span."""


def read(rec):
    t, n = rec.counters.get("traced"), rec.counters.get("traced_steps")
    if not n or not t or "lm.attn.ns" not in t:
        return None
    return t["lm.attn.ns"] / n / 1e6
