"""The paper's own configurations: the HE parameter sets (Table II, in
``core/params.py``), the MM benchmark grid (Table III), the FAME
accelerator configurations (Table IV) and the verification and chain twins
of the sets — counterpart of ``repro/configs/fame_sets.py``.

Table IV's values are the paper's FPGA figures, unchanged.  On the port
they map onto the H100 kernels as follows: ``dp`` (the FPGA's lanes) is
the width of the fused HLT's output tile (``kernels/fused_hlt.py``
``tile_size``: 256 coefficients a block, 4 a thread), and
``scratchpad_mb`` (the on-chip working memory) is what one block's shared
memory plays (``core/costmodel.py`` ``SMEM_PER_BLOCK``, 227 KB), which the
cost model checks the fused kernels' per-block footprint against.
``num_pes`` (parallel ciphertext pipelines) has no knob: the grid's batch
axis spreads ciphertexts over every SM.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.params import SET_A, SET_B, SET_C, HEParams, toy_params


@dataclasses.dataclass(frozen=True)
class FameAccelConfig:
    """Table IV: one FAME accelerator configuration."""
    name: str
    he: HEParams
    num_pes: int           # parallel ciphertext pipelines
    dp: int                # lanes of a pipeline
    scratchpad_mb: float   # on-chip scratchpad
    freq_mhz: int          # FPGA clock (for the paper's latencies)


FAME_S = FameAccelConfig("FAME-S", SET_A, num_pes=2, dp=128,
                         scratchpad_mb=864 / 1024, freq_mhz=350)
FAME_M = FameAccelConfig("FAME-M", SET_B, num_pes=2, dp=128,
                         scratchpad_mb=7.6, freq_mhz=350)
FAME_L = FameAccelConfig("FAME-L", SET_C, num_pes=1, dp=256,
                         scratchpad_mb=30.4, freq_mhz=300)

FAME_CONFIGS = {"fame-s": FAME_S, "fame-m": FAME_M, "fame-l": FAME_L}

# Table III: benchmark (m, l, n) per HE set, 4 shape types
MM_BENCHMARKS = {
    "set-a": {"type-i": (64, 64, 16), "type-ii": (64, 16, 64),
              "type-iii": (16, 64, 64), "type-iv": (64, 64, 64)},
    "set-b": {"type-i": (128, 128, 16), "type-ii": (128, 16, 128),
              "type-iii": (16, 128, 128), "type-iv": (128, 128, 128)},
    "set-c": {"type-i": (160, 160, 16), "type-ii": (160, 16, 160),
              "type-iii": (16, 160, 160), "type-iv": (160, 160, 160)},
}

# Fig. 6: FAME's average and largest speed-up over the best CPU library,
# as the paper reports them (the largest at 160-160-160, Set-C)
PAPER_FAME_AVG_SPEEDUP = 221.0
PAPER_FAME_MAX_SPEEDUP = 1337.0

HE_SETS = {"set-a": SET_A, "set-b": SET_B, "set-c": SET_C}

# CPU-runnable twins of the paper sets: the same chain structure (L, k, β)
# at a small ring, for the parity tests
FAME_VERIFY_SETS = {
    "fame-s-rt": toy_params(logN=6, L=4, k=3, beta=2, scale_bits=26,
                            name="fame-s-rt"),
    "fame-m-rt": toy_params(logN=7, L=5, k=2, beta=3, scale_bits=26,
                            name="fame-m-rt"),
}

# Chain-capable twins: L = 9 affords 3 hemm hops (3 levels each); β = 5
# keeps each key-switch digit at 2 main primes under the special modulus P
# (with the verify sets' β a digit at L = 9 packs 4–5 primes, overruns P,
# and the key-switch noise destroys the first hop)
FAME_CHAIN_SETS = {
    "fame-s-chain": toy_params(logN=6, L=9, k=3, beta=5, scale_bits=26,
                               name="fame-s-chain"),
    "fame-m-chain": toy_params(logN=7, L=9, k=2, beta=5, scale_bits=26,
                               name="fame-m-chain"),
}
