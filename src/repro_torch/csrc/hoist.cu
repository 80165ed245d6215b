// hoist_bc_ntt: the second half of the batched hoist — ModUp BaseConv of one
// digit's scaled coefficient rows onto one target limb (HPS, float64 floor
// correction), forward NTT, and the digit's own limbs passed through.
// The first half (iNTT · q̂^-1 of all B·nq limb rows) is intt_scale.cu.
//
// Replaces: src/repro/kernels/basechange.py:hoist_db (the TPU kernel,
// grid over ciphertexts, with a 2-slot DMA ping-pong over a zero-padded
// (β·α + M)-row copy of each c1).  The ping-pong exists only because the
// TPU runs its grid in order; here many blocks in flight hide the copy, so
// the hoist is two launches computing the same function, and both read c1
// in place: digit j's rows are c1 rows j·α.. (the last digit may be short;
// the reference's padded rows contribute exactly zero, so they are skipped).
//
// Bound on an H100: bytes.  Per ciphertext the function reads its nq c1
// rows and writes β·M output rows; the scaled rows are re-read once per
// target limb (L2 serves the repeats: one ciphertext's rows are ≤ 2 MB at
// Set-B); the BaseConv is α Montgomery MACs and α float64 MACs per output
// value.  Design: one block per (target limb, digit, ciphertext); the
// BaseConv result lands straight in shared memory, where the NTT runs all
// stages; own-limb blocks only copy their passthrough row.
//
// baseconv_ntt: the same device body for one ciphertext, with the
// reference's operands: the scaled digit rows y (β·α, N, zero-padded) are
// an input, and the own rows come from a (M, N) passthrough.  Replaces
// src/repro/kernels/basechange.py:baseconv_ntt (the TPU kernel, grid
// (digit, target limb)); bound by bytes as above, one block per (target
// limb, digit).  With intt_scale.cu before it, it is the single hoist
// (basechange.py:hoist_fused).
#include "common.cuh"

namespace {

// One block: BaseConv of the na scaled rows yj (stride N) onto target limb
// m, forward NTT in shared memory, written to o.  wr / id: the digit's α
// weights of this limb and its α float64 inv_d; dm: D mod q_m.
__device__ void bc_ntt_row(const uint32_t* __restrict__ yj, int na,
                           const uint32_t* __restrict__ wr,
                           const double* __restrict__ id, uint32_t dm,
                           const uint32_t* __restrict__ psi_row, uint32_t q,
                           uint32_t qn, int logN, uint32_t* s,
                           uint32_t* __restrict__ o) {
  const int N = 1 << logN;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    double fs = 0.0;
    uint32_t acc = 0u;
    for (int a = 0; a < na; ++a) {
      const uint32_t yv = yj[static_cast<long long>(a) * N + c];
      fs = a == 0 ? __dmul_rn(static_cast<double>(yv), id[0])
                  : fame::fmac_nofuse(fs, yv, id[a]);
      acc = fame::montadd(acc, fame::montmul(yv, wr[a], q, qn), q);
    }
    const uint32_t v = fame::floor_count(fs);
    s[c] = fame::montsub(acc, fame::montmul(v, dm, q, qn), q);
  }
  __syncthreads();
  fame::block_ntt_fwd(s, logN, psi_row, q, qn);
  for (int c = threadIdx.x; c < N; c += blockDim.x) o[c] = s[c];
}

__device__ __forceinline__ void copy_row(const uint32_t* __restrict__ src,
                                         uint32_t* __restrict__ o, int N) {
  for (int c = threadIdx.x; c < N; c += blockDim.x) o[c] = src[c];
}

__global__ void hoist_bc_ntt_kernel(const uint32_t* __restrict__ y,
                                    const uint32_t* __restrict__ c1,
                                    long long c1_bstride,
                                    uint32_t* __restrict__ out, int nbeta,
                                    int alpha, int nq, int M, int logN,
                                    const uint32_t* __restrict__ w,
                                    const uint32_t* __restrict__ dmod,
                                    const double* __restrict__ inv_d,
                                    const uint32_t* __restrict__ psi,
                                    const uint32_t* __restrict__ q32,
                                    const uint32_t* __restrict__ qneg,
                                    const uint32_t* __restrict__ mask) {
  extern __shared__ uint32_t s[];
  const int m = blockIdx.x;
  const int j = blockIdx.y;
  const long long b = blockIdx.z;
  const int N = 1 << logN;
  uint32_t* o = out + ((b * nbeta + j) * M + m) * static_cast<long long>(N);
  if (mask[j * M + m] != 0u) {                 // digit's own limb: passthrough
    copy_row(c1 + b * c1_bstride + static_cast<long long>(m) * N, o, N);
    return;
  }
  const int na = min(alpha, nq - j * alpha);   // the digit's real rows
  bc_ntt_row(y + (b * nq + static_cast<long long>(j) * alpha) * N, na,
             w + (static_cast<long long>(j) * M + m) * alpha,
             inv_d + static_cast<long long>(j) * alpha, dmod[j * M + m],
             psi + static_cast<long long>(m) * N, q32[m], qneg[m], logN, s, o);
}

__global__ void baseconv_ntt_kernel(const uint32_t* __restrict__ y,
                                    const uint32_t* __restrict__ pt,
                                    uint32_t* __restrict__ out, int M,
                                    int alpha, int logN,
                                    const uint32_t* __restrict__ w,
                                    const uint32_t* __restrict__ dmod,
                                    const double* __restrict__ inv_d,
                                    const uint32_t* __restrict__ psi,
                                    const uint32_t* __restrict__ q32,
                                    const uint32_t* __restrict__ qneg,
                                    const uint32_t* __restrict__ mask) {
  extern __shared__ uint32_t s[];
  const int m = blockIdx.x;
  const int j = blockIdx.y;
  const int N = 1 << logN;
  uint32_t* o = out + (static_cast<long long>(j) * M + m) * N;
  if (mask[j * M + m] != 0u) {
    copy_row(pt + static_cast<long long>(m) * N, o, N);
    return;
  }
  // padded rows of a short digit carry zero y, w and inv_d: exactly zero
  bc_ntt_row(y + static_cast<long long>(j) * alpha * N, alpha,
             w + (static_cast<long long>(j) * M + m) * alpha,
             inv_d + static_cast<long long>(j) * alpha, dmod[j * M + m],
             psi + static_cast<long long>(m) * N, q32[m], qneg[m], logN, s, o);
}

}  // namespace

extern "C" int hoist_bc_ntt_launch(const uint32_t* y, const uint32_t* c1,
                                   long long c1_bstride, uint32_t* out, int B,
                                   int nbeta, int alpha, int nq, int M,
                                   int logN, const uint32_t* w,
                                   const uint32_t* dmod, const double* inv_d,
                                   const uint32_t* psi, const uint32_t* q32,
                                   const uint32_t* qneg, const uint32_t* mask,
                                   void* stream) {
  cudaError_t err = fame::reserve_row_smem(hoist_bc_ntt_kernel, logN);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(M, nbeta, B);
  hoist_bc_ntt_kernel<<<grid, fame::row_threads(logN), sizeof(uint32_t) << logN,
                        static_cast<cudaStream_t>(stream)>>>(
      y, c1, c1_bstride, out, nbeta, alpha, nq, M, logN, w, dmod, inv_d, psi,
      q32, qneg, mask);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int baseconv_ntt_launch(const uint32_t* y, const uint32_t* pt,
                                   uint32_t* out, int nbeta, int alpha, int M,
                                   int logN, const uint32_t* w,
                                   const uint32_t* dmod, const double* inv_d,
                                   const uint32_t* psi, const uint32_t* q32,
                                   const uint32_t* qneg, const uint32_t* mask,
                                   void* stream) {
  cudaError_t err = fame::reserve_row_smem(baseconv_ntt_kernel, logN);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(M, nbeta);
  baseconv_ntt_kernel<<<grid, fame::row_threads(logN), sizeof(uint32_t) << logN,
                        static_cast<cudaStream_t>(stream)>>>(
      y, pt, out, M, alpha, logN, w, dmod, inv_d, psi, q32, qneg, mask);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
