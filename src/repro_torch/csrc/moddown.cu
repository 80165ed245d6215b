// moddown_finish: the tail of the merged ModDown+Rescale — HPS BaseConv from
// the nd scaled drop-basis rows onto one target limb (float64 floor
// correction), forward NTT, then (x − conv) · P^-1.
//
// Replaces: src/repro/kernels/basechange.py:moddown_finish (the TPU kernel,
// grid over target rows of one polynomial, the nd drop rows resident).
//
// Bound on an H100: bytes.  Per polynomial it reads the nd drop rows
// (once per target row; L2 serves the repeats), the target rows, the
// twiddles, and writes the output rows; the BaseConv is nd Montgomery MACs
// and nd float64 MACs per output value.  Design: one block per (target
// row, polynomial) so all 2·B polynomials of an HLT batch run in one
// launch; the BaseConv result lands in shared memory, where the NTT runs
// all stages, and the subtract-and-scale epilogue writes the row once.
#include "common.cuh"

namespace {

__global__ void moddown_finish_kernel(const uint32_t* __restrict__ x,
                                      long long x_bstride,
                                      const uint32_t* __restrict__ y,
                                      uint32_t* __restrict__ out, int R, int nd,
                                      int logN,
                                      const uint32_t* __restrict__ w,
                                      const uint32_t* __restrict__ dmod,
                                      const double* __restrict__ inv_d,
                                      const uint32_t* __restrict__ psi,
                                      const uint32_t* __restrict__ p_inv,
                                      const uint32_t* __restrict__ q32,
                                      const uint32_t* __restrict__ qneg) {
  extern __shared__ uint32_t s[];
  const int r = blockIdx.x;
  const long long p = blockIdx.y;
  const int N = 1 << logN;
  const uint32_t q = q32[r], qn = qneg[r];
  const uint32_t* yp = y + p * nd * static_cast<long long>(N);
  const uint32_t* wr = w + static_cast<long long>(r) * nd;
  const uint32_t dm = dmod[r];
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    double fs = 0.0;
    uint32_t acc = 0u;
    for (int i = 0; i < nd; ++i) {
      const uint32_t yv = yp[static_cast<long long>(i) * N + c];
      fs = i == 0 ? __dmul_rn(static_cast<double>(yv), inv_d[0])
                  : fame::fmac_nofuse(fs, yv, inv_d[i]);
      acc = fame::montadd(acc, fame::montmul(yv, wr[i], q, qn), q);
    }
    const uint32_t v = fame::floor_count(fs);
    s[c] = fame::montsub(acc, fame::montmul(v, dm, q, qn), q);
  }
  __syncthreads();
  fame::block_ntt_fwd(s, logN, psi + static_cast<long long>(r) * N, q, qn);
  const uint32_t* xr = x + p * x_bstride + static_cast<long long>(r) * N;
  uint32_t* o = out + (p * R + r) * static_cast<long long>(N);
  const uint32_t pi = p_inv[r];
  for (int c = threadIdx.x; c < N; c += blockDim.x)
    o[c] = fame::montmul(fame::montsub(xr[c], s[c], q), pi, q, qn);
}

}  // namespace

extern "C" int moddown_finish_launch(const uint32_t* x, long long x_bstride,
                                     const uint32_t* y, uint32_t* out, int P,
                                     int R, int nd, int logN, const uint32_t* w,
                                     const uint32_t* dmod, const double* inv_d,
                                     const uint32_t* psi, const uint32_t* p_inv,
                                     const uint32_t* q32, const uint32_t* qneg,
                                     void* stream) {
  cudaError_t err = fame::reserve_row_smem(moddown_finish_kernel, logN);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(R, P);
  moddown_finish_kernel<<<grid, fame::row_threads(logN),
                          sizeof(uint32_t) << logN,
                          static_cast<cudaStream_t>(stream)>>>(
      x, x_bstride, y, out, R, nd, logN, w, dmod, inv_d, psi, p_inv, q32, qneg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
