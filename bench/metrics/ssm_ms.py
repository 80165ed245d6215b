"""ssm_ms: ms a decode step spends in its Mamba-2 mixers (span ``lm.ssm``:
in_proj, the conv, the SSD and the write of its state, out_proj), summed
over the step's layers and averaged over the traced requests that were
not profiled, each span synchronised at both ends; None where the program
has no such span."""


def read(rec):
    t, n = rec.counters.get("traced"), rec.counters.get("traced_steps")
    if not n or not t or "lm.ssm.ns" not in t:
        return None
    return t["lm.ssm.ns"] / n / 1e6
