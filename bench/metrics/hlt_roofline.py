"""hlt_roofline: the HLT stages' least time (``costs``: Step 1 and Step 2)
over the device-busy time inside their span, in the profiled requests, in
%."""
from spans import roofline


def read(rec):
    return roofline(rec, "hlt")
