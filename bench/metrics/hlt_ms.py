"""hlt_ms: ms a request from the stage hook's ``start`` to ``step2`` (Step 1,
the Step-2 hoist, Step 2), averaged over the traced requests that were not
profiled."""
from spans import mean_ms


def read(rec):
    return mean_ms(rec, "hlt")
