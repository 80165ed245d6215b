// intt_scale: per-row inverse NTT, then montmul by the row's N^-1 and by a
// per-row Montgomery scale (q̂^-1 of a hoist digit row, or of a ModDown
// drop-basis row).
//
// Replaces: src/repro/kernels/basechange.py:intt_scale (the TPU kernel,
// grid over rows, one resident iNTT pass per row).
//
// Bound on an H100: bytes.  Each row is read once and written once (8N
// bytes) plus its twiddle row (4N); the log2(N) butterfly stages run in
// shared memory, so the ~N·log2(N)/2 Montgomery products stay far below
// the card's integer rate.  Design: one block per (batch, row), the row
// resident in dynamic shared memory for all stages, twiddles read through
// __ldg (they are shared by every batch element and stay in L2).  At
// N = 2^15 a block takes 128 KiB, so one block runs per SM: occupancy, not
// bandwidth, limits this first version.
#include "common.cuh"

namespace {

__global__ void intt_scale_kernel(const uint32_t* __restrict__ x,
                                  long long x_bstride,
                                  uint32_t* __restrict__ out, int R, int logN,
                                  const uint32_t* __restrict__ psii,
                                  const uint32_t* __restrict__ ninv,
                                  const uint32_t* __restrict__ scale,
                                  const uint32_t* __restrict__ q32,
                                  const uint32_t* __restrict__ qneg) {
  extern __shared__ uint32_t s[];
  const int r = blockIdx.x;
  const long long b = blockIdx.y;
  const int N = 1 << logN;
  const uint32_t* xr = x + b * x_bstride + static_cast<long long>(r) * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) s[j] = xr[j];
  __syncthreads();
  const uint32_t q = q32[r], qn = qneg[r];
  fame::block_intt(s, logN, psii + static_cast<long long>(r) * N, q, qn);
  const uint32_t ni = ninv[r], sc = scale[r];
  uint32_t* o = out + (b * R + r) * static_cast<long long>(N);
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    o[j] = fame::montmul(fame::montmul(s[j], ni, q, qn), sc, q, qn);
}

}  // namespace

extern "C" int intt_scale_launch(const uint32_t* x, long long x_bstride,
                                 uint32_t* out, int B, int R, int logN,
                                 const uint32_t* psii, const uint32_t* ninv,
                                 const uint32_t* scale, const uint32_t* q32,
                                 const uint32_t* qneg, void* stream) {
  cudaError_t err = fame::reserve_row_smem(intt_scale_kernel, logN);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(R, B);
  intt_scale_kernel<<<grid, fame::row_threads(logN), sizeof(uint32_t) << logN,
                      static_cast<cudaStream_t>(stream)>>>(
      x, x_bstride, out, R, logN, psii, ninv, scale, q32, qneg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
