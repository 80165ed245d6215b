// modmul / modadd: element-wise Montgomery product and modular add of two
// (M, N) residue arrays, limb i reduced mod q_i.
//
// Replaces: src/repro/kernels/modmul.py:modmul and :modadd (the TPU
// kernels, grid (limb, N / block) with a (1, block) tile of each operand
// and the limb's (1, 1) constants — the paper's modular ALU array).
//
// Bound on an H100: bytes.  Each value reads 8 bytes and writes 4 against
// one Montgomery product (4 32-bit multiplies) or one add, far below the
// card's integer rate.  Design: grid (coefficient tile, limb), one thread
// per coefficient, the limb's q / qneg read once per block into shared
// memory; neighbouring threads touch neighbouring words, so every load and
// store is coalesced.  The ragged last tile is masked, so any N works (the
// TPU's block argument has no counterpart).
#include "common.cuh"

namespace {

constexpr int kTile = 256;

template <bool kMul>
__global__ void __launch_bounds__(kTile)
elementwise_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ q32,
                   const uint32_t* __restrict__ qneg,
                   uint32_t* __restrict__ out, int N) {
  __shared__ uint32_t s_q, s_qn;
  const int i = blockIdx.y;
  if (threadIdx.x == 0) {
    s_q = q32[i];
    s_qn = kMul ? qneg[i] : 0u;
  }
  __syncthreads();
  const int j = blockIdx.x * kTile + threadIdx.x;
  if (j >= N) return;
  const long long o = static_cast<long long>(i) * N + j;
  out[o] = kMul ? fame::montmul(x[o], y[o], s_q, s_qn)
                : fame::montadd(x[o], y[o], s_q);
}

dim3 grid_of(int M, int N) { return dim3((N + kTile - 1) / kTile, M, 1); }

}  // namespace

extern "C" int modmul_launch(const uint32_t* x, const uint32_t* y,
                             const uint32_t* q32, const uint32_t* qneg,
                             uint32_t* out, int M, int N, void* stream) {
  elementwise_kernel<true><<<grid_of(M, N), kTile, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, y, q32, qneg, out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int modadd_launch(const uint32_t* x, const uint32_t* y,
                             const uint32_t* q32, uint32_t* out, int M, int N,
                             void* stream) {
  elementwise_kernel<false><<<grid_of(M, N), kTile, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, y, q32, nullptr, out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
