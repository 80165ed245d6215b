// Shared device routines of the port's kernels: u32 Montgomery arithmetic
// (R = 2^32) and a block-resident negacyclic NTT / iNTT in shared memory.
//
// montmul mirrors repro/core/modmath.py montmul step for step; the TPU's
// 16-bit mulhi32 emulation becomes the native __umulhi.  Inputs a, b < 2^30
// (any residue times any residue < q·2^32) give the canonical result in
// [0, q), equal to the reference's bit for bit.
//
// block_ntt_fwd / block_intt mirror ntt_mont_raw / intt_mont_raw
// (repro/core/ntt.py:84,102): Cooley–Tukey natural -> bit-reversed order,
// Gentleman–Sande back, twiddles in the Montgomery domain.  One block owns
// one row of N u32 values in dynamic shared memory (128 KiB at N = 2^15);
// twiddles are read once per butterfly through __ldg from global memory,
// because row plus twiddle row would exceed a Hopper block's 227 KB.
// The caller synchronises after filling the row; each stage ends with
// __syncthreads(), so the row is complete when the routine returns.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace fame {

__device__ __forceinline__ uint32_t montmul(uint32_t a, uint32_t b, uint32_t q,
                                            uint32_t qneg) {
  uint32_t lo = a * b;
  uint32_t hi = __umulhi(a, b);
  uint32_t m = lo * qneg;
  uint32_t mq_hi = __umulhi(m, q);
  // (x + m*q) / 2^32: the low words cancel exactly; carry = 1 iff lo != 0
  uint32_t t = hi + mq_hi + (lo != 0u ? 1u : 0u);
  return t >= q ? t - q : t;
}

__device__ __forceinline__ uint32_t montadd(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t montsub(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t d = a + q - b;
  return d >= q ? d - q : d;
}

// HPS floor correction term y * inv_d, accumulated without FMA contraction
// so the rounding is that of the reference's separate multiply and add.
__device__ __forceinline__ double fmac_nofuse(double acc, uint32_t y, double inv_d) {
  return __dadd_rn(acc, __dmul_rn(static_cast<double>(y), inv_d));
}

__device__ __forceinline__ uint32_t floor_count(double s) {
  return static_cast<uint32_t>(floor(__dadd_rn(s, 0.5e-6)));
}

__device__ void block_ntt_fwd(uint32_t* s, int logN,
                              const uint32_t* __restrict__ psi, uint32_t q,
                              uint32_t qneg) {
  const int half = 1 << (logN - 1);
  for (int lm = 0; lm < logN; ++lm) {          // m = 2^lm groups, t = N/2m
    const int lt = logN - lm - 1;
    const int tmask = (1 << lt) - 1;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> lt;
      const int i0 = (i << (lt + 1)) + (k & tmask);
      const int i1 = i0 + (1 << lt);
      const uint32_t w = __ldg(psi + (1 << lm) + i);
      const uint32_t u = s[i0];
      const uint32_t v = montmul(s[i1], w, q, qneg);
      s[i0] = montadd(u, v, q);
      s[i1] = montsub(u, v, q);
    }
    __syncthreads();
  }
}

// Inverse transform without the final N^-1 factor (the caller folds it
// into its epilogue, as intt_mont_raw ends with one montmul by n_inv).
__device__ void block_intt(uint32_t* s, int logN,
                           const uint32_t* __restrict__ psii, uint32_t q,
                           uint32_t qneg) {
  const int half = 1 << (logN - 1);
  for (int lh = logN - 1; lh >= 0; --lh) {     // h = 2^lh groups, t = N/2h
    const int lt = logN - 1 - lh;
    const int tmask = (1 << lt) - 1;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> lt;
      const int i0 = (i << (lt + 1)) + (k & tmask);
      const int i1 = i0 + (1 << lt);
      const uint32_t w = __ldg(psii + (1 << lh) + i);
      const uint32_t u = s[i0];
      const uint32_t v = s[i1];
      s[i0] = montadd(u, v, q);
      s[i1] = montmul(montsub(u, v, q), w, q, qneg);
    }
    __syncthreads();
  }
}

// Threads per block for a block-resident row of 2^logN values.
inline int row_threads(int logN) {
  int half = 1 << (logN - 1);
  return half < 1024 ? (half < 32 ? 32 : half) : 1024;
}

// Dynamic shared memory of one row; above 48 KB the kernel must opt in.
template <typename K>
inline cudaError_t reserve_row_smem(K kernel, int logN) {
  size_t bytes = sizeof(uint32_t) << logN;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fame
