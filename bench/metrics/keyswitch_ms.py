"""keyswitch_ms: host ms a program call spends in the engine's key switch
(span ``he.key_switch``, the l relinearisations of the loop), averaged
over every program call of the run: the warm-up call, the window's and the
profiled request's; None where the program has no such span."""


def read(rec):
    c = rec.counters
    if not c.get("he.call.calls") or "he.key_switch.ns" not in c:
        return None
    return c["he.key_switch.ns"] / c["he.call.calls"] / 1e6
