// ntt / intt: the per-limb negacyclic transforms of the engine's own
// datapath (encode, the keyswitch inside mult, its ModDown, rescale) —
// forward NTT (standard-domain natural-order coefficients -> bit-reversed
// evaluation order) and inverse NTT including the final N^-1 factor, both
// with Montgomery twiddles; the same butterflies as ntt_mont_raw /
// intt_mont_raw (core/ntt.py), so the output is the same bit for bit.
//
// Replaces: src/repro/kernels/ntt.py:ntt and :intt (the TPU kernels, grid
// (batch, limb), one VMEM-resident pass of all log2(N) stages per row).
//
// Bound on an H100: bytes.  Each (batch, limb) row is read once and
// written once (8N bytes) and each limb's twiddle row is read once (4N);
// the N/2·log2(N) Montgomery products per row stay far below the card's
// integer rate.  The engine calls it on 1-22 rows at a time, so a launch
// is short and mostly latency: the design spreads each row over several
// SMs and keeps the per-stage cost in registers.
//
// Design: one (batch, limb) row per thread-block cluster of C = 2^c blocks
// (C from the row count and N, kernels/ntt.py cluster_size; 1-16), the
// split transform of common.cuh (split_fwd_row, which hoist.cu and
// moddown.cu share; split_inv_row, which intt_scale.cu shares; all launch
// through launch_split).  Forward: block k loads the C segments
// x[a·n + k·R + (0 … R)] (n = N/C, R = n/C; coalesced), runs the c cross
// stages in registers, and stores each value into the shared memory of
// the block that owns its chunk (distributed shared memory); after a
// cluster barrier block a runs the log2(n) local stages on chunk a, three
// stages a pass with 8 values a thread, and writes chunk a out.  Inverse:
// the mirror — block a loads chunk a, runs the local stages (the last pass
// held in registers across a cluster barrier), scatters each value to the
// block owning its r, and that block runs the c cross stages, the N^-1
// factor, and writes its C segments.  Each block copies the n − 1 local
// twiddles of its chunk into shared memory once, during the first loads,
// so the passes read them there.  Shared memory per block: the padded
// chunk and its twiddle table, 2n values (33 KB at N = 2^15, C = 8; a
// 2^16 row over 8 blocks, 66 KB, opts in above 48 KB).
// Inputs are row slices of larger polynomials (a digit's limbs, the
// special limbs, one last limb): rows are contiguous, so the kernel takes
// a batch stride and reads them in place.
#include "common.cuh"

namespace {

template <int LOGC>
__global__ void __launch_bounds__(1024)
    ntt_fwd_split(const uint32_t* __restrict__ x, long long x_bstride,
                  uint32_t* __restrict__ out, int M, int logN,
                  const uint32_t* __restrict__ psi,
                  const uint32_t* __restrict__ q32,
                  const uint32_t* __restrict__ qneg) {
  extern __shared__ uint32_t s[];
  const int m = blockIdx.x >> LOGC;
  const long long b = blockIdx.y;
  const int n = 1 << (logN - LOGC);
  const long long row = static_cast<long long>(m) << logN;
  const uint32_t* xr = x + b * x_bstride + row;
  uint32_t* o = out + (b * M + m) * (1LL << logN);
  const uint32_t q = q32[m], qn = qneg[m];
  fame::split_fwd_row<LOGC>(
      s, logN, psi + row, q, qn,
      [&](int r0, uint32_t* v) {
#pragma unroll
        for (int a = 0; a < (1 << LOGC); ++a) v[a] = xr[a * n + r0];
      },
      [&](int j, uint32_t val) { o[j] = val; });
}

template <int LOGC>
__global__ void __launch_bounds__(1024)
    ntt_inv_split(const uint32_t* __restrict__ x, long long x_bstride,
                  uint32_t* __restrict__ out, int M, int logN,
                  const uint32_t* __restrict__ psii,
                  const uint32_t* __restrict__ ninv,
                  const uint32_t* __restrict__ q32,
                  const uint32_t* __restrict__ qneg) {
  extern __shared__ uint32_t s[];
  const int m = blockIdx.x >> LOGC;
  const long long b = blockIdx.y;
  const long long row = static_cast<long long>(m) << logN;
  const uint32_t* xr = x + b * x_bstride + row;
  uint32_t* o = out + (b * M + m) * (1LL << logN);
  const uint32_t q = q32[m], qn = qneg[m], ni = ninv[m];
  fame::split_inv_row<LOGC>(
      s, logN, psii + row, q, qn, [&](int j) { return xr[j]; },
      [&](int j, uint32_t c) { o[j] = fame::montmul(c, ni, q, qn); });
}

}  // namespace

// the kernels by log2 of the cluster size
const decltype(&ntt_fwd_split<0>) kFwd[] = {
    ntt_fwd_split<0>, ntt_fwd_split<1>, ntt_fwd_split<2>, ntt_fwd_split<3>,
    ntt_fwd_split<4>};
const decltype(&ntt_inv_split<0>) kInv[] = {
    ntt_inv_split<0>, ntt_inv_split<1>, ntt_inv_split<2>, ntt_inv_split<3>,
    ntt_inv_split<4>};

extern "C" int ntt_launch(const uint32_t* x, long long x_bstride,
                          uint32_t* out, int B, int M, int logN, int logc,
                          const uint32_t* psi, const uint32_t* q32,
                          const uint32_t* qneg, void* stream) {
  if (!fame::split_shape_ok(logN, logc))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fame::launch_split(
      kFwd[logc], logc, B, M, logN, static_cast<cudaStream_t>(stream), x,
      x_bstride, out, M, logN, psi, q32, qneg));
}

extern "C" int intt_launch(const uint32_t* x, long long x_bstride,
                           uint32_t* out, int B, int M, int logN, int logc,
                           const uint32_t* psii, const uint32_t* ninv,
                           const uint32_t* q32, const uint32_t* qneg,
                           void* stream) {
  if (!fame::split_shape_ok(logN, logc))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fame::launch_split(
      kInv[logc], logc, B, M, logN, static_cast<cudaStream_t>(stream), x,
      x_bstride, out, M, logN, psii, ninv, q32, qneg));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
