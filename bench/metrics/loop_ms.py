"""loop_ms: ms a request from the stage hook's ``step2`` to ``mult_rescale``
(the l ciphertext products, rescales and their sum), averaged over the
traced requests that were not profiled."""
from spans import mean_ms


def read(rec):
    return mean_ms(rec, "loop")
