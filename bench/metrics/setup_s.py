"""setup_s: seconds from the harness's first line to the first timed
request (imports, kernels, keys, inputs, compile, one warm-up request)."""


def read(rec):
    return rec.setup_s
