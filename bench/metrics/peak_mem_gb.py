"""peak_mem_gb: the device memory the CUDA allocator held at its peak
over the whole run (set-up and window), in GB (1e9 bytes)."""


def read(rec):
    return rec.peak_bytes / 1e9 if rec.peak_bytes else None
