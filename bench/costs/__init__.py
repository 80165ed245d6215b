"""The benchmark's table of peaks and its least-work functions.

The peaks are those of one NVIDIA H100 SXM (data sheet, dense rates): HBM3
at 3.35 TB/s and 67 T 32-bit operations a second outside the tensor cores.
A roofline share is a stage's least time (``<kind>.least``) over the device
time the stage took, so it cannot pass 100% while the counts are lower
bounds.
"""
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
WORD_BYTES = 4
