"""arena_gb: the bytes that the program's operand arena
(``HEContext.arena``: plaintext diagonals and keys laid out for the HLT
kernels) holds after compile, in GB (1e9 bytes); a program counter."""


def read(rec):
    return rec.counters["arena_bytes"] / 1e9
