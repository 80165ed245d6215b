"""loop_roofline: the loop's least time (``costs``: its 2·l input
ciphertexts, the relinearisation key and the output) over the device-busy
time inside its span, in the profiled requests, in %."""
from spans import roofline


def read(rec):
    return roofline(rec, "loop")
