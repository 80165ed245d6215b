"""device_idle: the share of the profiled requests' host time (each
synchronised at both ends) in which no operation ran on the device, in %."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    return (1 - tr.busy_in("request") / tr.length("request")) * 100
