// ntt / intt: the per-limb negacyclic transforms of the engine's own
// datapath (encode, the keyswitch inside mult, its ModDown, rescale) —
// forward NTT (standard-domain natural-order coefficients -> bit-reversed
// evaluation order) and inverse NTT including the final N^-1 factor, both
// with Montgomery twiddles (common.cuh block_ntt_fwd / block_intt).
//
// Replaces: src/repro/kernels/ntt.py:ntt and :intt (the TPU kernels, grid
// (batch, limb), one VMEM-resident pass of all log2(N) stages per row).
//
// Bound on an H100: bytes.  Each (batch, limb) row is read once and
// written once (8N bytes) and each limb's twiddle row is read once (4N);
// the N/2·log2(N) Montgomery products per row stay far below the card's
// integer rate.  Design: one block per (limb, batch) row, the row resident
// in dynamic shared memory for all stages (128 KiB at N = 2^15, opt-in
// above 48 KB), twiddles through __ldg.  Inputs are row slices of larger
// polynomials (a digit's limbs, the special limbs, one last limb): rows
// are contiguous, so the kernel takes a batch stride and reads them in
// place.  The engine calls it on 1-22 rows at a time: fewer blocks than
// the 132 SMs, so one launch is latency-bound, not bandwidth-bound.
#include "common.cuh"

namespace {

__device__ __forceinline__ void load_row(uint32_t* s,
                                         const uint32_t* __restrict__ xr,
                                         int N) {
  for (int j = threadIdx.x; j < N; j += blockDim.x) s[j] = xr[j];
  __syncthreads();
}

__global__ void ntt_fwd_kernel(const uint32_t* __restrict__ x,
                               long long x_bstride,
                               uint32_t* __restrict__ out, int M, int logN,
                               const uint32_t* __restrict__ psi,
                               const uint32_t* __restrict__ q32,
                               const uint32_t* __restrict__ qneg) {
  extern __shared__ uint32_t s[];
  const int r = blockIdx.x;
  const long long b = blockIdx.y;
  const int N = 1 << logN;
  load_row(s, x + b * x_bstride + static_cast<long long>(r) * N, N);
  fame::block_ntt_fwd(s, logN, psi + static_cast<long long>(r) * N, q32[r],
                      qneg[r]);
  uint32_t* o = out + (b * M + r) * static_cast<long long>(N);
  for (int j = threadIdx.x; j < N; j += blockDim.x) o[j] = s[j];
}

__global__ void ntt_inv_kernel(const uint32_t* __restrict__ x,
                               long long x_bstride,
                               uint32_t* __restrict__ out, int M, int logN,
                               const uint32_t* __restrict__ psii,
                               const uint32_t* __restrict__ ninv,
                               const uint32_t* __restrict__ q32,
                               const uint32_t* __restrict__ qneg) {
  extern __shared__ uint32_t s[];
  const int r = blockIdx.x;
  const long long b = blockIdx.y;
  const int N = 1 << logN;
  const uint32_t q = q32[r], qn = qneg[r];
  load_row(s, x + b * x_bstride + static_cast<long long>(r) * N, N);
  fame::block_intt(s, logN, psii + static_cast<long long>(r) * N, q, qn);
  const uint32_t ni = ninv[r];
  uint32_t* o = out + (b * M + r) * static_cast<long long>(N);
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    o[j] = fame::montmul(s[j], ni, q, qn);
}

}  // namespace

extern "C" int ntt_launch(const uint32_t* x, long long x_bstride,
                          uint32_t* out, int B, int M, int logN,
                          const uint32_t* psi, const uint32_t* q32,
                          const uint32_t* qneg, void* stream) {
  cudaError_t err = fame::reserve_row_smem(ntt_fwd_kernel, logN);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(M, B);
  ntt_fwd_kernel<<<grid, fame::row_threads(logN), sizeof(uint32_t) << logN,
                   static_cast<cudaStream_t>(stream)>>>(
      x, x_bstride, out, M, logN, psi, q32, qneg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int intt_launch(const uint32_t* x, long long x_bstride,
                           uint32_t* out, int B, int M, int logN,
                           const uint32_t* psii, const uint32_t* ninv,
                           const uint32_t* q32, const uint32_t* qneg,
                           void* stream) {
  cudaError_t err = fame::reserve_row_smem(ntt_inv_kernel, logN);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(M, B);
  ntt_inv_kernel<<<grid, fame::row_threads(logN), sizeof(uint32_t) << logN,
                   static_cast<cudaStream_t>(stream)>>>(
      x, x_bstride, out, M, logN, psii, ninv, q32, qneg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
