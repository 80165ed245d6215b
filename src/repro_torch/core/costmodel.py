"""Paper §III cost model: on-chip memory requirement for HE MM (Eqs. 16–24),
operation counts (Table I), traffic estimates, and the compile-time
schedule pick — counterpart of ``repro/core/costmodel.py``.

Two word models:
 * ``paper`` — B_coeff = logq_paper/8 bytes a coefficient (54-bit FPGA
   words); reproduces the §III-B3 numbers (0.43/3.6 MB Set-A, 6.7/61 MB
   Set-B, 27/255 MB Set-C, Eq. 24 ≈ 29 MB);
 * ``u32``   — 4-byte residue words with ~2× the limb count for equal
   log Q (``core/params.py``): the port's storage, and the word model of
   the byte counts below (the reference calls the same model ``"tpu"``).

The device terms are the H100's.  The fused kernels keep their working
set in one block's shared memory (``SMEM_PER_BLOCK``, 227 KB opt-in),
allocated exactly at launch: the fused HLT's two-stage ring
(``kernels/fused_hlt.py`` ``smem_bytes``) and the split row kernels'
chunk and twiddles (``kernels/basechange.py`` ``split_smem_bytes``).
``select_schedule`` picks ``"pallas"`` (the fused kernels) when every one
of them accepts the parameter set, else ``"mo"``: a compile-time decision
that ``HLTPlan.schedule`` records, never a fallback at run time.

``pick_rotation_chunk`` picks no padding.  The reference's rotation chunk
is how many rotations its TPU kernel keeps resident a grid step; the CUDA
rotation kernel loops over all d rotations itself and stages one rotation
ahead (``csrc/fused_hlt.cu``), so its footprint does not depend on the
chunk and the chunk only pads d with zero-diagonal rotations, which are
wasted work.  ``compile_hlt`` therefore resolves ``rotation_chunk=None``
to chunk = d_max, so d_pad = d_max.

The mesh terms (``sharded_collective_bytes``, the sharded side of
``select_schedule``, ``select_chain_schedules``) price the multi-device
schedule (``core/hlt_dist.py``): a compile on ``HEContext(mesh=)`` sees
the mesh's n_model and n_ct, and the pick may be ``"sharded"``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hemm import diag_count_formulas
from repro_torch.core.params import HEParams
from repro_torch.distributed.hlo_analysis import HW
from repro_torch.kernels import basechange, fused_hlt

MB = float(1 << 20)

#: One block's shared memory on an H100 with the opt-in attribute
#: (``cudaFuncAttributeMaxDynamicSharedMemorySize``): 227 KB of the SM's
#: 228 KB.  This is the budget of the fused kernels' per-block footprint,
#: the FPGA scratchpad's counterpart, and it takes the place of the
#: reference's VMEM size and headroom both: a launch allocates exactly its
#: footprint (its ring of two stages included), so no headroom is kept.
SMEM_PER_BLOCK = 227.0 * 1024

#: Cost of one cross-device byte relative to one local HBM byte (used as
#: HBM-equivalent bytes per collective byte): the H100 SXM data sheet's
#: HBM3 against NVLink 4 a direction (``distributed/hlo_analysis.py``
#: ``HW``).
ICI_PENALTY = HW["hbm_bw"] / HW["ici_bw"]

# Representative per-HLT diagonal count when the caller doesn't know d yet
# (σ of a 16×16 single-ciphertext MM tile: 2·16−1).
_DEFAULT_D = 31

#: Largest ring the fused kernels take (``kernels/basechange.py``
#: ``SPLIT_MAX_LOGN``: a row over a cluster of at most 16 blocks, chunks
#: of at most 2^13 values), and the smallest (a chunk of 8 values).
_MAX_LOGN, _MIN_LOGN = 16, 3


def fused_stage_working_sets(params: "HEParams", *, nbeta: int,
                             d: int | None = None, level: int | None = None,
                             batch: int = 1,
                             hoists: int | None = None) -> dict:
    """Per-block shared-memory bytes of each fused stage at one compile
    point, as the launches allocate them: ``rot`` the rotation kernel at
    the limb group it takes at d (``kernels/fused_hlt.py`` ``smem_bytes``,
    ``limb_group``), ``hoist`` the batched hoist of ``hoists`` ciphertexts
    (default ``batch``), ``moddown`` the merged ModDown over the 2·``batch``
    output polynomials (``kernels/basechange.py``).  ``level`` (default the
    top) sizes the extended basis and the hoist's limbs."""
    level = params.L if level is None else level
    d = _DEFAULT_D if d is None else d
    hoists = batch if hoists is None else hoists
    N, m_ext = params.N, level + 1 + params.k
    return {
        "rot": fused_hlt.smem_bytes(nbeta, N,
                                    fused_hlt.limb_group(m_ext, d)),
        "hoist": basechange.hoist_smem_bytes(hoists, nbeta, level + 1,
                                             m_ext, N),
        "moddown": basechange.moddown_smem_bytes(2 * batch, params.k + 1,
                                                 level, N),
    }


def fused_kernels_accept(params: "HEParams", nbeta: int | None = None,
                         smem_bytes: float = SMEM_PER_BLOCK) -> bool:
    """Whether every fused kernel takes the parameter set: a ring of
    2^3 … 2^16 (the split row kernels), N a multiple of the rotation
    kernel's 4-value accesses, and each kernel's per-block footprint at
    its smallest (one limb a block, one row a launch) within the budget."""
    nbeta = params.beta if nbeta is None else nbeta
    N = params.N
    if not _MIN_LOGN <= params.logN <= _MAX_LOGN or N % 4:
        return False
    footprint = max(fused_hlt.smem_bytes(nbeta, N, 1),
                    basechange.split_smem_bytes(1, N))
    return footprint <= smem_bytes


def pick_rotation_chunk(d: int) -> int:
    """The rotation chunk of the fused schedule: d itself, so d_pad = d
    (no zero-diagonal padding; module docstring)."""
    return max(1, int(d))


def sharded_collective_bytes(params: "HEParams", *, n_model: int = 1,
                             ctb: int = 1) -> int:
    """Predicted per-execution collective traffic of a limb-sharded HLT:
    a ring all-reduce of the merged ModDown's (k+1) dropped rows for both
    output polynomials of every ciphertext, ~2·(n−1)/n of the payload a
    device."""
    if n_model <= 1:
        return 0
    payload = 2 * (params.k + 1) * params.N * 4 * max(1, ctb)
    return int(2 * (n_model - 1) / n_model * payload)


def hlt_operand_bytes(params: "HEParams", *, d: int,
                      nbeta: int | None = None,
                      n_limbs_ext: int | None = None) -> float:
    """Rotation-loop operand footprint of one HLT (keys + diagonals)."""
    nbeta = params.beta if nbeta is None else nbeta
    m = (params.L + 1 + params.k) if n_limbs_ext is None else n_limbs_ext
    return d * (2 * nbeta + 1) * m * 4.0 * params.N


def hlt_hoist_bytes(params: "HEParams", nbeta: int | None = None,
                    n_limbs_ext: int | None = None) -> float:
    """Bytes of ONE hoisting product (β digit expansions + raised c0/c1):
    the unit the ciphertext-slot dedup saves per repeated input."""
    nbeta = params.beta if nbeta is None else nbeta
    m = (params.L + 1 + params.k) if n_limbs_ext is None else n_limbs_ext
    return (nbeta + 2) * m * 4.0 * params.N


#: Device bytes a batched fused HLT's transients may hold at once
#: (``step2_chunk``).  One HLT at level ℓ holds 16·N·(ℓ + k + 1) bytes:
#: at Set-B's Step-2 level 14 that is 12.06 MB, so 8 GiB takes 712 HLTs.
#: That keeps in one chunk the Set-B hemm 128³ (256 Step-2 HLTs), the
#: block MM (512), each chain hop, the Set-C hemm 32³ (64 at 45.1 MB) and
#: a serving group of (3, 2, 2) tiles (640), while an LM group of
#: (1, 32, 1) tiles (4096) runs in 6 chunks instead of holding 49.4 GB at
#: once beside ~30 GB of keys, arenas and model on an 80 GB card.
STEP2_BUDGET_BYTES = 8 << 30


def hlt_transient_bytes(params: "HEParams", level: int) -> int:
    """Device bytes one batched fused HLT at input level ``level`` holds
    between its rotation kernel and its merged ModDown+Rescale, both
    output polynomials in u32 words: the fused output over the extended
    basis (ℓ+1+k rows), the iNTT'd drop rows (k+1) and the result (ℓ)."""
    m_ext = level + 1 + params.k
    rows = m_ext + (params.k + 1) + level
    return 2 * rows * 4 * params.N


def step2_chunk(params: "HEParams", level: int, batch: int) -> int:
    """HLTs a chunk when a batched fused HLT of ``batch`` at ``level``
    runs in consecutive chunks (``CompiledHLT``): as few chunks as keep
    each within ``STEP2_BUDGET_BYTES`` of transients, of near-equal size.
    Step 2 is the batch that reaches the budget; the residues do not
    depend on the chunking."""
    cap = max(1, STEP2_BUDGET_BYTES // hlt_transient_bytes(params, level))
    n_chunks = -(-batch // cap)
    return -(-batch // n_chunks)


def loop_transient_bytes(params: "HEParams", level: int) -> int:
    """Device bytes one product of the batched mult → rescale loop
    (``compile.product_sums``) at input level ``level`` holds at its peak,
    counted in rows of N u32 words, n = ℓ+1 over Q_ℓ and F = n + k over
    Q_ℓ ∪ P.  Through the key switch the four stacked inputs and d0, d1,
    d2 stay (7·n) beside the two accumulators (2·F); then the largest of
    a key product (the raised digit and an accumulator in int64, the new
    accumulator: 5·F) or a digit's BaseConv (at most 5·F + 4), a ModDown's
    subtraction (its NTT'd conversion and the int64 temporaries, 7.25·n),
    and ``mult``'s last two additions (16.25·n in all)."""
    n = level + 1
    full = n + params.k
    rows4 = max(28 * n + 28 * full + 16, 57 * n + 8 * full, 65 * n)
    return rows4 * params.N


def loop_chunk(params: "HEParams", level: int, batch: int,
               step2_batch: int) -> int:
    """Products a chunk when ``batch`` products at input level ``level``
    run as batched mult → rescale (``compile.product_sums``): as few
    chunks as keep each within what a chunk of the same program's Step 2
    (``step2_batch`` HLTs at level ℓ+1) frees once it has written its
    results, which stay through the loop (the fused output and the drop
    rows), of near-equal size: so the loop never sets a call's memory
    peak.  The residues do not depend on the chunking."""
    lv2 = level + 1
    freed = hlt_transient_bytes(params, lv2) - 2 * lv2 * 4 * params.N
    cap = max(1, freed * step2_chunk(params, lv2, step2_batch)
              // loop_transient_bytes(params, level))
    n_chunks = -(-batch // cap)
    return -(-batch // n_chunks)


def select_schedule(params: "HEParams", nbeta: int | None = None,
                    smem_bytes: float = SMEM_PER_BLOCK, *,
                    n_model: int = 1, n_ct: int = 1,
                    d: int | None = None, ctb: int | None = None,
                    n_uniq: int | None = None,
                    dedup_hoist: bool = True) -> str:
    """Schedule pick for ``compile_hlt`` / ``compile_hemm`` /
    ``compile_blockmm`` with ``schedule=None``.

    One device: ``"pallas"`` when ``fused_kernels_accept`` holds (every
    shipped set), else ``"mo"``, the reference's pick where even chunk = 1
    overflows its budget.

    A mesh (``n_model``-way limb × ``n_ct``-way ciphertext sharding)
    compares per-device bytes, the reference's inequality::

        rot·B_pad/(n_model·n_ct) + hoist·U/n_model + ICI_PENALTY·coll
            <  rot·B + hoist·U                       ->  "sharded"

    with ``rot = hlt_operand_bytes(d)``, ``hoist = hlt_hoist_bytes()``, B
    the batch, B_pad it padded to the ct axis, U the unique inputs and
    ``coll = sharded_collective_bytes``; ``dedup_hoist=False`` charges the
    sharded side one hoist per element."""
    single = ("pallas" if fused_kernels_accept(params, nbeta, smem_bytes)
              else "mo")
    n_model, n_ct = max(1, n_model), max(1, n_ct)
    if n_model * n_ct <= 1 or single != "pallas":
        return single
    nbeta = params.beta if nbeta is None else nbeta
    single_dev, shard_dev = _hlt_device_costs(
        params, nbeta=nbeta, d=d, ctb=ctb, n_uniq=n_uniq,
        n_model=n_model, n_ct=n_ct, dedup_hoist=dedup_hoist)
    return "sharded" if shard_dev < single_dev else single


def _hlt_device_costs(params: "HEParams", *, nbeta: int, d: int | None,
                      ctb: int | None, n_uniq: int | None,
                      n_model: int, n_ct: int,
                      dedup_hoist: bool = True) -> tuple[float, float]:
    """(single-device bytes, per-device sharded bytes) of one HLT launch:
    the two sides of ``select_schedule``'s inequality."""
    d_eff = _DEFAULT_D if d is None else d
    ctb_eff = max(1, ctb or 1)
    uniq = ctb_eff if n_uniq is None else max(1, min(n_uniq, ctb_eff))
    b_pad = -(-ctb_eff // n_ct) * n_ct          # slot/zero-ct padded batch
    operand = hlt_operand_bytes(params, d=d_eff, nbeta=nbeta)
    hoist = hlt_hoist_bytes(params, nbeta=nbeta)
    single_dev = operand * ctb_eff + hoist * uniq
    shard_hoist = hoist * (uniq if dedup_hoist else b_pad / n_ct) / n_model
    shard_dev = (operand * b_pad / (n_model * n_ct) + shard_hoist
                 + ICI_PENALTY * sharded_collective_bytes(
                     params, n_model=n_model, ctb=b_pad // n_ct))
    return single_dev, shard_dev


def chain_boundary_bytes(params: "HEParams", *,
                         level: int | None = None) -> float:
    """Interconnect-penalised bytes to re-lay a chained ciphertext out
    when adjacent hops change residency class (single ↔ sharded): both
    polynomials at the boundary level cross once, at ``ICI_PENALTY``."""
    n_limbs = (params.L if level is None else level) + 1
    return ICI_PENALTY * 2.0 * n_limbs * 4.0 * params.N


def select_chain_schedules(params: "HEParams", hops, *,
                           smem_bytes: float = SMEM_PER_BLOCK,
                           n_model: int = 1, n_ct: int = 1) -> tuple:
    """Joint per-hop schedule pick for a chain of hemm hops.

    ``hops``: per-hop dicts with ``d`` (the widest HLT's rotations),
    ``ctb`` (HLT batch), ``n_uniq`` (unique inputs), ``nbeta`` and
    ``level`` (the hop's input level).  A two-state dynamic program over
    the hops prices each hop with ``_hlt_device_costs`` and each change of
    residency class with ``chain_boundary_bytes``.  On one device every
    hop takes its ``select_schedule`` pick."""
    n_model, n_ct = max(1, n_model), max(1, n_ct)
    k = len(hops)
    if k < 1:
        raise ValueError("a chain needs at least one hop")
    INF = float("inf")
    singles, costs = [], []
    for hop in hops:
        nbeta = hop.get("nbeta") or params.beta
        sname = ("pallas" if fused_kernels_accept(params, nbeta, smem_bytes)
                 else "mo")
        singles.append(sname)
        single_dev, shard_dev = _hlt_device_costs(
            params, nbeta=nbeta, d=hop.get("d"), ctb=hop.get("ctb"),
            n_uniq=hop.get("n_uniq"), n_model=n_model, n_ct=n_ct)
        if n_model * n_ct <= 1 or sname != "pallas":
            shard_dev = INF               # sharded not viable for this hop
        costs.append((single_dev, shard_dev))
    # DP over residency classes: 0 = single-device, 1 = sharded.
    best = [list(costs[0])] + [[INF, INF] for _ in range(k - 1)]
    back = [[0, 0] for _ in range(k)]
    for h in range(1, k):
        bnd = chain_boundary_bytes(params, level=hops[h].get("level"))
        for c in (0, 1):
            for p in (0, 1):
                t = best[h - 1][p] + costs[h][c] + (bnd if p != c else 0.0)
                if t < best[h][c]:
                    best[h][c], back[h][c] = t, p
    c = 0 if best[k - 1][0] <= best[k - 1][1] else 1
    path = [c]
    for h in range(k - 1, 0, -1):
        c = back[h][c]
        path.append(c)
    path.reverse()
    return tuple("sharded" if cls else singles[h] for h, cls in enumerate(path))


def hlt_stage_costs(params: "HEParams", *, d: int, d_pad: int, nbeta: int,
                    chunk: int, n_limbs_ext: int, n_model: int = 1,
                    ctb: int = 1, n_hoist: int | None = None) -> dict:
    """Per-stage byte / rotation / collective counts of ONE HLT at a
    compile point (u32 words), attached to ``HLTPlan``: ``bytes`` the
    operand traffic a ciphertext streams (per device under limb
    sharding), ``rotations`` the real ones, ``collective_bytes`` the
    merged ModDown's share.  ``n_hoist`` hoisting products are computed
    for ``ctb`` elements (default ``ctb``), which amortizes the hoist."""
    row = 4 * params.N
    m = n_limbs_ext
    nm = max(1, n_model)
    m_loc = -(-m // nm)                  # per-device rows (padded shard)
    nh = ctb if n_hoist is None else max(1, min(n_hoist, ctb))
    coll = sharded_collective_bytes(params, n_model=nm, ctb=ctb)
    return {
        "hoist": {                       # Decomp/ModUp digits + raised c0/c1
            "bytes": int(hlt_hoist_bytes(params, nbeta=nbeta,
                                         n_limbs_ext=m_loc)) * nh
            // max(1, ctb),
            "rotations": 0, "collective_bytes": 0},
        "automorph": {                   # per-rotation perm-table gather
            "bytes": d_pad * (1 + nbeta) * m_loc * row, "rotations": d,
            "collective_bytes": 0},
        "keyip": {                       # 2β rot-key rows per rotation
            "bytes": 2 * nbeta * d_pad * m_loc * row, "rotations": d,
            "collective_bytes": 0},
        "diagip": {                      # one diagonal row per rotation
            "bytes": d_pad * m_loc * row, "rotations": d,
            "collective_bytes": 0},
        "moddown": {                     # merged ModDown+Rescale in/out
            "bytes": 2 * m_loc * row, "rotations": 0,
            "collective_bytes": coll},
        "chunk": chunk,
    }


def serve_amortization(params: "HEParams", *, nbeta: int | None = None,
                       n_calls: int, n_tiles: int, n_uniq_tiles: int,
                       launches: int, launches_naive: int) -> dict:
    """Amortization stats of one batched serving step: ``n_calls``
    requests folded together, ``n_tiles`` activation tiles of which
    ``n_uniq_tiles`` unique (each repeat skips one ``hlt_hoist_bytes``),
    ``launches`` / ``launches_naive`` from ``BlockMMPlan``."""
    hoist = hlt_hoist_bytes(params, nbeta=nbeta)
    n_uniq_tiles = max(0, min(n_uniq_tiles, n_tiles))
    return {
        "n_calls": int(n_calls),
        "launches": int(launches),
        "launches_naive": int(launches_naive),
        "launch_amortization_x": launches_naive / max(1, launches),
        "hoist_bytes": int(hoist * n_uniq_tiles),
        "hoist_bytes_naive": int(hoist * n_tiles),
        "hoist_dedup_saved_bytes": int(hoist * (n_tiles - n_uniq_tiles)),
    }


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Paper §III data sizes, on-chip memory requirements and traffic.

    ``word_model="paper"`` uses 54-bit FPGA words and reproduces the
    paper's §III-B3 megabytes; ``"u32"`` uses the port's 4-byte words."""

    params: HEParams
    word_model: str = "paper"     # "paper" | "u32"

    def __post_init__(self):
        if self.word_model not in ("paper", "u32"):
            raise ValueError(f"word_model={self.word_model!r}: \"paper\" or "
                             f"\"u32\"")

    # -- data sizes (§III-B1) ------------------------------------------------

    @property
    def bytes_per_coeff(self) -> float:
        """Bytes per polynomial coefficient under the word model."""
        if self.word_model == "paper":
            return self.params.logq_paper / 8.0
        return 4.0

    @property
    def b_limb(self) -> float:
        """Bytes of one RNS limb row (Eq. 16): N coefficients."""
        return self.params.N * self.bytes_per_coeff

    def b_ct(self, nlimbs: int | None = None) -> float:
        """Eq. 17 (at full level by default): 2 polys × limbs × limb bytes."""
        n = self.params.num_main if nlimbs is None else nlimbs
        return 2.0 * n * self.b_limb

    def b_evk(self, nlimbs_ext: int | None = None) -> float:
        """Eq. 18."""
        p = self.params
        n = (p.L + p.k + 1) if nlimbs_ext is None else nlimbs_ext
        return 2.0 * p.beta * n * self.b_limb

    # -- on-chip memory requirement (§III-B2) ---------------------------------

    @property
    def m_keyswitch(self) -> float:
        """Eq. 19: output Ct + β-digit extended expansion of one poly."""
        p = self.params
        return self.b_ct() + 0.5 * p.beta * self.b_ct(p.L + p.k + 1)

    @property
    def m_rot(self) -> float:
        """Eq. 20: + original (a,b) and ψ(a)."""
        return self.m_keyswitch + 1.5 * self.b_ct()

    @property
    def m_hlt_s1(self) -> float:
        """Eq. 21: one input buffer + two output buffers (+ in-place MAC)."""
        return self.m_rot + 3.0 * self.b_ct()

    @property
    def m_hlt_s2(self) -> float:
        """Eq. 22: two input buffers (A^(0), B^(0) reused across iterations)."""
        return self.m_rot + 4.0 * self.b_ct()

    @property
    def m_hemm(self) -> float:
        """Eq. 23: + accumulator Ct_AB."""
        return self.m_hlt_s2 + self.b_ct()

    @property
    def m_mo_hlt(self) -> float:
        """Eq. 24: MO-HLT stores one Ct + (β+1) intermediate limbs."""
        return self.b_ct() + (self.params.beta + 1) * self.b_limb

    # -- traffic model ---------------------------------------------------------

    def baseline_hlt_traffic(self, d: int, sram_bytes: float) -> float:
        """Off-chip Ct traffic of the coarse-grained HLT (Fig. 2(A)) when
        the working set (m_hemm) exceeds on-chip memory: every Rot spills
        the extended Ct between sub-operations."""
        if self.m_hemm <= sram_bytes:
            return 2.0 * self.b_ct()          # just input + output
        p = self.params
        ext = 0.5 * p.beta * self.b_ct(p.L + p.k + 1)
        per_rot = 2.0 * (ext + self.b_ct(p.L + p.k + 1))   # spill + refill
        return 2.0 * self.b_ct() + d * per_rot

    # d is unused by design — MO fuses all d rotations on-chip; the signature
    # mirrors baseline_hlt_traffic so the two are interchangeable.
    def mo_hlt_traffic(self, d: int, sram_bytes: float) -> float:  # noqa: ARG002
        """MO-HLT: input Ct read + output Ct write; only the unfused
        BaseConv stages (ModUp/ModDown) round-trip limbs when the Ct
        exceeds on-chip memory."""
        base = 2.0 * self.b_ct()
        if self.m_mo_hlt <= sram_bytes:
            return base
        p = self.params
        return base + 2.0 * (p.k + 1) * self.b_limb * 2.0

    # -- Table I ---------------------------------------------------------------

    def table1_counts(self, m: int, l: int, n: int) -> dict:
        """Paper Table I: HE op counts per Algorithm-2 step for (m, l, n)."""
        d = diag_count_formulas(m, l, n)
        phi = d["sigma"] + d["tau"]
        zeta = l * (d["eps"] + d["omega"])
        return {
            "step1": {"Add": phi, "Mult": 0, "CMult": phi, "Rot": phi, "Depth": 1},
            "step2": {"Add": zeta + l, "Mult": l, "CMult": zeta, "Rot": zeta,
                      "Depth": 2},
            "total": {"Add": phi + zeta + l, "Mult": l, "CMult": phi + zeta,
                      "Rot": phi + zeta, "Depth": 3},
        }


def report(params: HEParams, word_model: str = "paper") -> dict:
    """Summarize the §III-B3 memory numbers for one parameter set (MB)."""
    cm = CostModel(params, word_model)
    return {
        "set": params.name,
        "word_model": word_model,
        "B_ct_MB": cm.b_ct() / MB,
        "M_keyswitch_MB": cm.m_keyswitch / MB,
        "M_rot_MB": cm.m_rot / MB,
        "M_hlt_s2_MB": cm.m_hlt_s2 / MB,
        "M_hemm_MB": cm.m_hemm / MB,
        "M_mo_hlt_MB": cm.m_mo_hlt / MB,
        "reduction_x": cm.m_hemm / cm.m_mo_hlt,
    }
