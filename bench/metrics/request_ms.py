"""request_ms: the window's seconds (its start to the end of its last
completed request) over the requests completed, in ms; untraced run."""


def read(rec):
    return rec.window_s / rec.requests * 1e3
