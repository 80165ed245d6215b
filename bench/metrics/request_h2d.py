"""request_h2d: host-to-device copies a program call starts (counter
``he.call.h2d``, counted at each site that builds a device tensor from
host data), averaged over every program call of the run: the warm-up call
(with the first call's one-time tables), the window's and the profiled
request's; None where the program has no such counter."""


def read(rec):
    c = rec.counters
    if not c.get("he.call.calls") or "he.call.h2d" not in c:
        return None
    return c["he.call.h2d"] / c["he.call.calls"]
