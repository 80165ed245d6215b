// intt_scale: per-row inverse NTT, then montmul by the row's N^-1 and by a
// per-row Montgomery scale (q̂^-1 of a hoist digit row, or of a ModDown
// drop-basis row).
//
// Replaces: src/repro/kernels/basechange.py:intt_scale (the TPU kernel,
// grid over rows, one resident iNTT pass per row).
//
// Bound on an H100: bytes.  Each row is read once and written once (8N
// bytes) plus its twiddle row (4N, shared by every batch element: L2
// serves the repeats); the N/2·log2(N) butterflies stay far below the
// card's integer rate.  The main path's launches are 36 rows (Step 1's
// merged ModDown), 2·nq (the hoist) and 4608 (Step 2's: 512 polynomials ×
// 9 drop rows).
//
// Design: one (batch, row) row per thread-block cluster of C = 2^c blocks
// (C from the launch's row count and N, kernels/ntt.py cluster_size;
// 1-16), common.cuh split_inv_row, as ntt.cu's intt: block k loads chunk
// k, runs the local stages three a pass in shared memory, exchanges each
// value through distributed shared memory to the block owning its r, and
// runs the cross stages in registers.  The epilogue is one Montgomery
// product by the row's constant f = montmul(N^-1, scale), folded on the
// host: montmul(montmul(x, N^-1), scale) and montmul(x, f) are both the
// canonical residue of x·N^-1·scale·2^-64 mod q, so the output is the
// reference's bit for bit.  The input rows are read in place: through
// the batch stride, and through an optional row table (row r of the
// output reads row rows[r] of each batch element), so the merged ModDown
// reads its drop rows out of the extended polynomial without a gather.
// A chunk takes 33 KB of shared memory at N = 2^15, C = 8, and a 2^16 row
// fits (66 KB at C = 8).
#include "common.cuh"

namespace {

template <int LOGC>
__global__ void __launch_bounds__(1024)
    intt_scale_split(const uint32_t* __restrict__ x, long long x_bstride,
                     const long long* __restrict__ rows,
                     uint32_t* __restrict__ out, int R, int logN,
                     const uint32_t* __restrict__ psii,
                     const uint32_t* __restrict__ fold,
                     const uint32_t* __restrict__ q32,
                     const uint32_t* __restrict__ qneg) {
  extern __shared__ uint32_t s[];
  const int r = blockIdx.x >> LOGC;
  const long long b = blockIdx.y;
  const long long N = 1LL << logN;
  const long long src = rows != nullptr ? rows[r] : r;
  const uint32_t* xr = x + b * x_bstride + src * N;
  uint32_t* o = out + (b * R + r) * N;
  const uint32_t q = q32[r], qn = qneg[r], f = fold[r];
  fame::split_inv_row<LOGC>(
      s, logN, psii + r * N, q, qn, [&](int j) { return xr[j]; },
      [&](int j, uint32_t c) { o[j] = fame::montmul(c, f, q, qn); });
}

}  // namespace

// the kernel by log2 of the cluster size
const decltype(&intt_scale_split<0>) kInttScale[] = {
    intt_scale_split<0>, intt_scale_split<1>, intt_scale_split<2>,
    intt_scale_split<3>, intt_scale_split<4>};

// rows: null (output row r reads input row r) or R int64 input row indices
extern "C" int intt_scale_launch(const uint32_t* x, long long x_bstride,
                                 const long long* rows, uint32_t* out, int B,
                                 int R, int logN, int logc,
                                 const uint32_t* psii, const uint32_t* fold,
                                 const uint32_t* q32, const uint32_t* qneg,
                                 void* stream) {
  if (!fame::split_shape_ok(logN, logc))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fame::launch_split(
      kInttScale[logc], logc, B, R, logN, static_cast<cudaStream_t>(stream),
      x, x_bstride, rows, out, R, logN, psii, fold, q32, qneg));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
