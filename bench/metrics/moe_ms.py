"""moe_ms: ms a decode step spends in the FFN after each mixer (span
``lm.moe``: the router, the routed experts and the shared expert), summed
over the step's layers and averaged over the traced requests that were
not profiled, each span synchronised at both ends; None where the program
has no such span."""


def read(rec):
    t, n = rec.counters.get("traced"), rec.counters.get("traced_steps")
    if not n or not t or "lm.moe.ns" not in t:
        return None
    return t["lm.moe.ns"] / n / 1e6
