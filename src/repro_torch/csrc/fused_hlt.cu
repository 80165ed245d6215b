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
// value.  Design: grid (coefficient tile, limb, batch element); each block
// reads its ct/diag slots itself (the scalar prefetch becomes a per-block
// index load) and loops over all d rotations, so the accumulators stay in
// registers and no output value is shared between blocks (no reduction
// across blocks).  Key, diagonal and permutation rows stream coalesced; the
// Automorph gathers hit one limb's β+1 hoisted rows (≈0.4 MB at Set-B),
// which L2 serves.  Montgomery adds are exact, so any loop order is
// bit-exact against the reference.
#include "common.cuh"

namespace {

constexpr int kTile = 256;

// Where batch element b finds its hoisting product and diagonal set.
enum class Slots { kIndexed, kSingle, kBatched };

// kIndexed: read from the slot vectors; kSingle: one ciphertext, both 0;
// kBatched: both b (stacked operands, no slot vectors).
template <Slots kSlots>
__global__ void __launch_bounds__(kTile)
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
                         uint32_t* __restrict__ out, int B, int nbeta, int M,
                         int N, int d) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  if (j >= N) return;
  const int i = blockIdx.y;
  const long long b = blockIdx.z;
  const long long h = kSlots == Slots::kIndexed ? ct_slots[b]
                      : kSlots == Slots::kBatched ? b : 0;
  const long long sl = kSlots == Slots::kIndexed ? diag_slots[b]
                       : kSlots == Slots::kBatched ? b : 0;
  const uint32_t q = q32[i], qn = qneg[i];
  const long long n = N;
  const uint32_t* dig = digits + (h * nbeta * M + i) * n;   // digit 0, limb i
  const long long dig_step = static_cast<long long>(M) * n;  // next digit
  const uint32_t* c0r = c0e + (h * M + i) * n;
  const uint32_t* c1r = c1e + (h * M + i) * n;
  const uint32_t c0j = c0r[j], c1j = c1r[j];
  uint32_t a0 = 0u, a1 = 0u;
  for (int r = 0; r < d; ++r) {
    const long long sr = sl * d + r;
    const uint32_t uv = u[(sr * M + i) * n + j];
    uint32_t t0, t1;
    if (is_id[sr] != 0) {
      t0 = c0j;
      t1 = c1j;
    } else {
      const int pm = perms[sr * n + j];
      uint32_t k0 = 0u, k1 = 0u;
      for (int jj = 0; jj < nbeta; ++jj) {
        const uint32_t dv = dig[jj * dig_step + pm];
        const long long kidx = ((sr * nbeta + jj) * M + i) * n + j;
        k0 = fame::montadd(k0, fame::montmul(dv, rk0[kidx], q, qn), q);
        k1 = fame::montadd(k1, fame::montmul(dv, rk1[kidx], q, qn), q);
      }
      t0 = fame::montadd(k0, c0r[pm], q);
      t1 = k1;
    }
    a0 = fame::montadd(a0, fame::montmul(uv, t0, q, qn), q);
    a1 = fame::montadd(a1, fame::montmul(uv, t1, q, qn), q);
  }
  const long long o = (b * M + i) * n + j;
  out[o] = a0;                                   // out[0, b, i, j]
  out[static_cast<long long>(B) * M * n + o] = a1;  // out[1, b, i, j]
}

}  // namespace

extern "C" int fused_hlt_indexed_launch(
    const uint32_t* digits, const uint32_t* c0e, const uint32_t* c1e,
    const uint32_t* u, const uint32_t* rk0, const uint32_t* rk1,
    const int32_t* perms, const int32_t* is_id, const int32_t* ct_slots,
    const int32_t* diag_slots, const uint32_t* q32, const uint32_t* qneg,
    uint32_t* out, int B, int nbeta, int M, int N, int d, void* stream) {
  dim3 grid((N + kTile - 1) / kTile, M, B);
  fused_hlt_kernel<Slots::kIndexed><<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      digits, c0e, c1e, u, rk0, rk1, perms, is_id, ct_slots, diag_slots, q32,
      qneg, out, B, nbeta, M, N, d);
  return static_cast<int>(cudaGetLastError());
}

// One ciphertext: digits (β, M, N), c0e/c1e (M, N), u (d, M, N), rk0/rk1
// (d, β, M, N), perms (d, N), is_id (d, 1) -> out (2, M, N).
extern "C" int fused_hlt_launch(
    const uint32_t* digits, const uint32_t* c0e, const uint32_t* c1e,
    const uint32_t* u, const uint32_t* rk0, const uint32_t* rk1,
    const int32_t* perms, const int32_t* is_id, const uint32_t* q32,
    const uint32_t* qneg, uint32_t* out, int nbeta, int M, int N, int d,
    void* stream) {
  dim3 grid((N + kTile - 1) / kTile, M, 1);
  fused_hlt_kernel<Slots::kSingle><<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      digits, c0e, c1e, u, rk0, rk1, perms, is_id, nullptr, nullptr, q32,
      qneg, out, 1, nbeta, M, N, d);
  return static_cast<int>(cudaGetLastError());
}

// A stacked batch: digits (B, β, M, N), c0e/c1e (B, M, N), u (B, d, M, N),
// rk0/rk1 (B, d, β, M, N), perms (B, d, N), is_id (B, d, 1) -> out
// (2, B, M, N).
extern "C" int fused_hlt_batched_launch(
    const uint32_t* digits, const uint32_t* c0e, const uint32_t* c1e,
    const uint32_t* u, const uint32_t* rk0, const uint32_t* rk1,
    const int32_t* perms, const int32_t* is_id, const uint32_t* q32,
    const uint32_t* qneg, uint32_t* out, int B, int nbeta, int M, int N,
    int d, void* stream) {
  dim3 grid((N + kTile - 1) / kTile, M, B);
  fused_hlt_kernel<Slots::kBatched>
      <<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
          digits, c0e, c1e, u, rk0, rk1, perms, is_id, nullptr, nullptr, q32,
          qneg, out, B, nbeta, M, N, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
