// fused_hlt_indexed: the slot-indexed batched MO-HLT rotation datapath —
// per output coefficient, for every rotation of the batch element's
// diagonal set: Automorph (gather by the Galois permutation) -> KeyIP (β
// Montgomery MACs against the rotation-key rows) -> DiagIP (× the
// plaintext diagonal), accumulated over all d rotations; is_id entries
// (z = 0 and the d-padding) bypass KeyIP.
//
// Replaces: src/repro/kernels/fused_hlt.py:fused_hlt_indexed (the TPU
// kernel, grid (batch, limb, rotation chunk) with scalar-prefetched slot
// vectors and the accumulator revisited across the sequential chunk axis),
// through the second entry point fused_hlt_launch, :fused_hlt (one
// ciphertext, grid (limb, rotation chunk)): the same device body with one
// batch element whose hoisting-product and diagonal slots are both 0; and,
// through the third entry point fused_hlt_batched_launch,
// :fused_hlt_batched (a stacked batch with no slot dedup, grid (batch,
// limb, rotation chunk)): the same body with both slots of batch element b
// equal to b, every operand carrying its own batch stride.  The TPU's
// rotation-chunk grid axis has no counterpart: every block loops over all
// d rotations, so the chunk only pads d.
//
// Bound on an H100: bytes.  Every rotation streams, per output value, its
// diagonal (4 B), 2β rotation-key words (8β B) and one permutation index
// (4 B, shared by all limbs); at Set-B hemm 128^3 Step 1 that is ~8.1 GB
// of operands (~2.4 ms at 3.35 TB/s), against 2β+2 Montgomery products per
// value.
//
// Design: grid (coefficient tile, limb group, batch element).  A block owns
// one output tile of T = min(256, N) coefficients for a group of g limbs
// (T/4 threads a limb, 4 coefficients a thread), reads its ct/diag slots
// itself (the TPU's scalar prefetch becomes a per-block index load) and
// loops over all d rotations with the accumulators in registers, so no
// output value is shared between blocks.  What it does about the costs of
// a plain per-coefficient gather:
// * The Automorph gathers.  A gather dig[pm] from device memory makes
//   neighbouring threads read far-apart words.  In the bit-reversed
//   evaluation order a Galois permutation maps every aligned T-tile of
//   outputs onto one aligned T-tile of sources (an odd g fixes the low
//   bits of (2r+1)·g mod 2N as a function of r's low bits, which bit
//   reversal makes the high bits of the position).  So for each rotation
//   the block votes (__syncthreads_and) whether all its pm >> log2 T agree;
//   if so it copies the source tile of the β digit rows and the c0 row of
//   each of its limbs (1 KB a row, coalesced) into shared memory and
//   gathers pm & (T − 1) there.  Any other permutation (random ones in
//   tests and the kernel API) gathers from device memory, so the kernel
//   computes the same function for every permutation, with no new table.
// * Latency.  Every operand of a rotation moves by cp.async into shared
//   memory a rotation ahead (its permutation row two ahead, so that the
//   vote for rotation r + 1 can run before r's MACs): rotation r + 1's
//   source tile, diagonal and key rows are in flight while rotation r
//   computes from shared memory, in a ring of two stages (three slots for
//   the permutation rows), two barriers a rotation.
// * The permutation row is read once per block and rotation for all g
//   limbs, M/g times per rotation instead of M.  The last group of a
//   ragged M is masked (its spare threads only join the barriers).
// * Every copy and the output move 16 bytes a thread (4 coefficients).
// Montgomery adds are exact, so any loop order is bit-exact against the
// reference; each value's operations are the reference's.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md
// §6): at the Set-B hemm's Step 1 / Step 2 the launch takes ~3.2 / ~3.9-4.3
// ms against byte bounds of 2.42 / 2.78 ms (one block a tile with the
// operands read in place before: 4.97 / 6.69); on random permutations,
// which gather from device memory, ~9.9 / ~9.3 ms.  Limb groups of 1-4
// differ by ~1.5 % at Step 1; at Step 2 (d = 2) one limb a block is
// fastest.
//
// An optional int32[3] `paths` counts (block, rotation) pairs that took the
// staged gather, the device-memory gather and the identity bypass.
#include "common.cuh"

namespace {

constexpr int kTileMax = 256;
constexpr int kVec = 4;                  // coefficients a thread
constexpr int kMaxThreads = 512;         // g·T/4: g <= 8 at T = 256

// Where batch element b finds its hoisting product and diagonal set.
enum class Slots { kIndexed, kSingle, kBatched };

__device__ __forceinline__ void cp_async16(void* smem, const void* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 lds4(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// element e of a 16-byte vector (e is a constant after unrolling)
__device__ __forceinline__ uint32_t elem(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ int elem(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Rows of T words a stage of the ring holds per limb: the β digit rows and
// c0 of the source tile, the diagonal, the 2β key rows.
__host__ __device__ __forceinline__ int stage_rows(int nbeta) {
  return 3 * nbeta + 2;
}

// kIndexed: read from the slot vectors; kSingle: one ciphertext, both 0;
// kBatched: both b (stacked operands, no slot vectors).  Dynamic shared
// memory: two stages of g limbs × (3β + 2) rows × T, then three permutation
// rows of T.
template <Slots kSlots>
__global__ void __launch_bounds__(kMaxThreads)
fused_hlt_kernel(const uint32_t* __restrict__ digits,
                 const uint32_t* __restrict__ c0e,
                 const uint32_t* __restrict__ c1e,
                 const uint32_t* __restrict__ u,
                 const uint32_t* __restrict__ rk0,
                 const uint32_t* __restrict__ rk1,
                 const int32_t* __restrict__ perms,
                 const int32_t* __restrict__ is_id,
                 const int32_t* __restrict__ ct_slots,
                 const int32_t* __restrict__ diag_slots,
                 const uint32_t* __restrict__ q32,
                 const uint32_t* __restrict__ qneg,
                 uint32_t* __restrict__ out, int B, int nbeta, int M, int N,
                 int d, int g, int* __restrict__ paths) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = N < kTileMax ? N : kTileMax;
  const int lt = 31 - __clz(T), lanes = T / kVec;
  const int li = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int i = blockIdx.y * g + li;
  const bool live = i < M;               // the last group may be ragged
  const int ic = live ? i : M - 1;
  const int tile = blockIdx.x, j0 = tile * T + lane * kVec;
  const long long b = blockIdx.z;
  const long long h = kSlots == Slots::kIndexed ? ct_slots[b]
                      : kSlots == Slots::kBatched ? b : 0;
  const long long sl = kSlots == Slots::kIndexed ? diag_slots[b]
                       : kSlots == Slots::kBatched ? b : 0;
  const uint32_t q = q32[ic], qn = qneg[ic];
  const long long n = N;
  const uint32_t* dig = digits + (h * nbeta * M + ic) * n;   // digit 0, limb i
  const long long dig_step = static_cast<long long>(M) * n;  // next digit
  const uint32_t* c0r = c0e + (h * M + ic) * n;
  const uint32_t* c1r = c1e + (h * M + ic) * n;

  // this thread's rows in a stage: source tile (β digits, c0), the
  // diagonal, rk0 (β), rk1 (β); then the ring of permutation rows
  const int stage_words = g * stage_rows(nbeta) * T;
  uint32_t* mine = smem + li * stage_rows(nbeta) * T;
  int32_t* prow = reinterpret_cast<int32_t*>(smem + 2 * stage_words);
  const int src_row = 0, u_row = nbeta + 1, rk_row = nbeta + 2;

  // copy rotation r's permutation row (the first limb's threads)
  auto fetch_perm = [&](int r) {
    if (li == 0)
      cp_async16(prow + (r % 3) * T + lane * kVec,
                 perms + (sl * d + r) * n + j0);
  };
  // copy rotation r's diagonal and, unless it is an identity, its key rows
  // and (if staged) the source tile t_src of the digit and c0 rows
  auto fetch_stage = [&](int r, bool id, int t_src) {
    if (!live) return;
    const long long sr = sl * d + r;
    uint32_t* st = mine + (r & 1) * stage_words + lane * kVec;
    cp_async16(st + u_row * T, u + (sr * M + i) * n + j0);
    if (id) return;
    for (int jj = 0; jj < nbeta; ++jj) {
      const long long kidx = ((sr * nbeta + jj) * M + i) * n + j0;
      cp_async16(st + (rk_row + jj) * T, rk0 + kidx);
      cp_async16(st + (rk_row + nbeta + jj) * T, rk1 + kidx);
    }
    if (t_src < 0) return;
    const long long src = static_cast<long long>(t_src) * T + lane * kVec;
    for (int jj = 0; jj < nbeta; ++jj)
      cp_async16(st + (src_row + jj) * T, dig + jj * dig_step + src);
    cp_async16(st + (src_row + nbeta) * T, c0r + src);
  };
  // rotation r's identity flag and the block's vote on its (landed)
  // permutation row: the source tile, or -1 where the gather is global
  auto vote = [&](int r, bool& id) -> int {
    id = is_id[sl * d + r] != 0;         // the same for the whole block
    if (id) return -1;
    const int32_t* pr = prow + (r % 3) * T;
    const int4 pm = *reinterpret_cast<const int4*>(pr + lane * kVec);
    const int t0 = pr[0] >> lt;
    const bool one = (pm.x >> lt) == t0 && (pm.y >> lt) == t0 &&
                     (pm.z >> lt) == t0 && (pm.w >> lt) == t0;
    return __syncthreads_and(one) ? t0 : -1;
  };

  uint32_t a0[kVec] = {0u, 0u, 0u, 0u}, a1[kVec] = {0u, 0u, 0u, 0u};
  int n_staged = 0, n_gather = 0, n_id = 0;

  fetch_perm(0);
  if (d > 1) fetch_perm(1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  bool id_next;
  int src_next = vote(0, id_next);
  fetch_stage(0, id_next, src_next);
  cp_async_commit();
  for (int r = 0; r < d; ++r) {
    const bool id = id_next;
    const int t_src = src_next;
    // rotation r's stage and rotation r + 1's permutation row have landed
    // (this thread's copies; the barrier makes every thread's visible, and
    // every thread is past rotation r − 1, the last reader of the stage
    // and permutation slots refilled below)
    cp_async_wait_all();
    __syncthreads();
    if (r + 1 < d) {
      src_next = vote(r + 1, id_next);
      if (r + 2 < d) fetch_perm(r + 2);
      fetch_stage(r + 1, id_next, src_next);
    }
    cp_async_commit();
    if (threadIdx.x == 0) {
      n_id += id;
      n_staged += !id && t_src >= 0;
      n_gather += !id && t_src < 0;
    }
    if (!live) continue;
    const uint32_t* st = mine + (r & 1) * stage_words + lane * kVec;
    const uint4 uv = lds4(st + u_row * T);
    uint32_t t0[kVec], t1[kVec];
    if (id) {
      const uint4 c0j = ld4(c0r + j0), c1j = ld4(c1r + j0);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        t0[e] = elem(c0j, e);
        t1[e] = elem(c1j, e);
      }
    } else {
      const int4 pm = *reinterpret_cast<const int4*>(prow + (r % 3) * T +
                                                     lane * kVec);
      // the gather's source: the staged tile at pm mod T, or the row
      const uint32_t* tile_src = mine + (r & 1) * stage_words;
      uint32_t k0[kVec] = {0u, 0u, 0u, 0u}, k1[kVec] = {0u, 0u, 0u, 0u};
      for (int jj = 0; jj <= nbeta; ++jj) {
        uint32_t dv[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int pe = elem(pm, e);
          dv[e] = t_src >= 0 ? tile_src[(src_row + jj) * T + (pe & (T - 1))]
                  : jj < nbeta ? dig[jj * dig_step + pe]
                               : c0r[pe];
        }
        if (jj == nbeta) {               // c0 of the rotated ciphertext
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            t0[e] = fame::montadd(k0[e], dv[e], q);
            t1[e] = k1[e];
          }
          break;
        }
        const uint4 r0v = lds4(st + (rk_row + jj) * T);
        const uint4 r1v = lds4(st + (rk_row + nbeta + jj) * T);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          k0[e] = fame::montadd(k0[e], fame::montmul(dv[e], elem(r0v, e), q, qn), q);
          k1[e] = fame::montadd(k1[e], fame::montmul(dv[e], elem(r1v, e), q, qn), q);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      a0[e] = fame::montadd(a0[e], fame::montmul(elem(uv, e), t0[e], q, qn), q);
      a1[e] = fame::montadd(a1[e], fame::montmul(elem(uv, e), t1[e], q, qn), q);
    }
  }
  if (paths != nullptr && threadIdx.x == 0) {
    atomicAdd(paths + 0, n_staged);
    atomicAdd(paths + 1, n_gather);
    atomicAdd(paths + 2, n_id);
  }
  if (!live) return;
  const long long o = (b * M + i) * n + j0;
  *reinterpret_cast<uint4*>(out + o) = make_uint4(a0[0], a0[1], a0[2], a0[3]);
  *reinterpret_cast<uint4*>(out + static_cast<long long>(B) * M * n + o) =
      make_uint4(a1[0], a1[1], a1[2], a1[3]);   // out[1, b, i, j]
}

// Grid, block and shared memory of a launch over B batch elements with
// limb groups of g; the launch error.
template <Slots kSlots, typename... Args>
cudaError_t launch(int B, int nbeta, int M, int N, int g, cudaStream_t stream,
                   Args... args) {
  const int T = N < kTileMax ? N : kTileMax;
  if (N % kVec != 0 || g < 1 || g * (T / kVec) > kMaxThreads)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(uint32_t) * (2 * static_cast<size_t>(g) * stage_rows(nbeta) + 3) * T;
  auto kernel = fused_hlt_kernel<kSlots>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(N / T, (M + g - 1) / g, B);
  kernel<<<grid, g * (T / kVec), smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_hlt_indexed_launch(
    const uint32_t* digits, const uint32_t* c0e, const uint32_t* c1e,
    const uint32_t* u, const uint32_t* rk0, const uint32_t* rk1,
    const int32_t* perms, const int32_t* is_id, const int32_t* ct_slots,
    const int32_t* diag_slots, const uint32_t* q32, const uint32_t* qneg,
    uint32_t* out, int B, int nbeta, int M, int N, int d, int g, int* paths,
    void* stream) {
  return static_cast<int>(launch<Slots::kIndexed>(
      B, nbeta, M, N, g, static_cast<cudaStream_t>(stream), digits, c0e, c1e,
      u, rk0, rk1, perms, is_id, ct_slots, diag_slots, q32, qneg, out, B,
      nbeta, M, N, d, g, paths));
}

// One ciphertext: digits (β, M, N), c0e/c1e (M, N), u (d, M, N), rk0/rk1
// (d, β, M, N), perms (d, N), is_id (d, 1) -> out (2, M, N).
extern "C" int fused_hlt_launch(
    const uint32_t* digits, const uint32_t* c0e, const uint32_t* c1e,
    const uint32_t* u, const uint32_t* rk0, const uint32_t* rk1,
    const int32_t* perms, const int32_t* is_id, const uint32_t* q32,
    const uint32_t* qneg, uint32_t* out, int nbeta, int M, int N, int d,
    int g, int* paths, void* stream) {
  return static_cast<int>(launch<Slots::kSingle>(
      1, nbeta, M, N, g, static_cast<cudaStream_t>(stream), digits, c0e, c1e,
      u, rk0, rk1, perms, is_id, nullptr, nullptr, q32, qneg, out, 1, nbeta,
      M, N, d, g, paths));
}

// A stacked batch: digits (B, β, M, N), c0e/c1e (B, M, N), u (B, d, M, N),
// rk0/rk1 (B, d, β, M, N), perms (B, d, N), is_id (B, d, 1) -> out
// (2, B, M, N).
extern "C" int fused_hlt_batched_launch(
    const uint32_t* digits, const uint32_t* c0e, const uint32_t* c1e,
    const uint32_t* u, const uint32_t* rk0, const uint32_t* rk1,
    const int32_t* perms, const int32_t* is_id, const uint32_t* q32,
    const uint32_t* qneg, uint32_t* out, int B, int nbeta, int M, int N,
    int d, int g, int* paths, void* stream) {
  return static_cast<int>(launch<Slots::kBatched>(
      B, nbeta, M, N, g, static_cast<cudaStream_t>(stream), digits, c0e, c1e,
      u, rk0, rk1, perms, is_id, nullptr, nullptr, q32, qneg, out, B, nbeta,
      M, N, d, g, paths));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
