"""keygen_s: host seconds of the context's key generation in set-up (span
``he.keygen``: the secret, the relinearisation key and the plan's rotation
keys), summed over the run's keygens (one); None where the program has no
such span."""


def read(rec):
    ns = rec.counters.get("he.keygen.ns")
    return None if ns is None else ns / 1e9
