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
// baseconv_ntt: the same device body for one ciphertext, with the
// reference's operands: the scaled digit rows y (β·α, N, zero-padded) are
// an input, and the own rows come from a (M, N) passthrough.  Replaces
// src/repro/kernels/basechange.py:baseconv_ntt (the TPU kernel, grid
// (digit, target limb)).  With intt_scale.cu before it, it is the single
// hoist (basechange.py:hoist_fused).
//
// Bound on an H100: bytes.  Per ciphertext the function reads its nq
// scaled rows and writes β·M output rows; the scaled rows are re-read once
// per target limb (L2 serves the repeats: one ciphertext's rows are ≤ 4 MB
// at Set-B); the BaseConv is α Montgomery MACs and α float64 MACs per
// output value, the NTT N/2·log2 N Montgomery products per row.
//
// Design: one (target limb m, digit j, ciphertext b) row per thread-block
// cluster of C = 2^c blocks (C from the launch's B·β·M rows and N,
// kernels/ntt.py cluster_size; 1-16), on common.cuh split_fwd_row as
// moddown.cu: block k's thread for offset r0 of its r-range computes the
// BaseConv of the digit's ≤ α scaled rows at the C positions a·n + r0 in
// registers (split_baseconv, the reference's float64 order), runs the c
// cross stages there, sends each value to the block of its chunk through
// distributed shared memory, and the local stages end in a plain write.
// A digit's own limb (mask[j, m]) is decided per cluster: each block of
// the cluster copies its chunk of the passthrough row and returns before
// any cluster barrier.  No row is held in one block, so logN 16 fits.
#include "common.cuh"

namespace {

// y: ny scaled rows per batch element (digit j at rows j·α.., the last
// digit's real rows min(α, ny − j·α)); pt: the passthrough rows, M a batch
// element at stride pt_bstride; grid (M << LOGC, B·nbeta).
template <int LOGC>
__global__ void __launch_bounds__(1024)
    bc_ntt_split(const uint32_t* __restrict__ y, int ny,
                 const uint32_t* __restrict__ pt, long long pt_bstride,
                 uint32_t* __restrict__ out, int nbeta, int alpha, int M,
                 int logN, const uint32_t* __restrict__ w,
                 const uint32_t* __restrict__ dmod,
                 const double* __restrict__ inv_d,
                 const uint32_t* __restrict__ psi,
                 const uint32_t* __restrict__ q32,
                 const uint32_t* __restrict__ qneg,
                 const uint32_t* __restrict__ mask) {
  extern __shared__ uint32_t s[];
  const int m = blockIdx.x >> LOGC;
  const int j = blockIdx.y % nbeta;
  const long long b = blockIdx.y / nbeta;
  const long long N = 1LL << logN;
  const int ln = logN - LOGC, n = 1 << ln;
  uint32_t* o = out + (static_cast<long long>(blockIdx.y) * M + m) * N;
  if (mask[j * M + m] != 0u) {        // the digit's own limb: passthrough
    const int k = static_cast<int>(cooperative_groups::this_cluster().block_rank());
    const uint32_t* src = pt + b * pt_bstride + m * N + (k << ln);
    for (int i = threadIdx.x; i < n; i += blockDim.x) o[(k << ln) + i] = src[i];
    return;
  }
  const int na = min(alpha, ny - j * alpha);    // the digit's real rows
  const uint32_t* yj = y + (b * ny + static_cast<long long>(j) * alpha) * N;
  const uint32_t* wr = w + (static_cast<long long>(j) * M + m) * alpha;
  const double* id = inv_d + static_cast<long long>(j) * alpha;
  const uint32_t dm = dmod[j * M + m], q = q32[m], qn = qneg[m];
  fame::split_fwd_row<LOGC>(
      s, logN, psi + m * N, q, qn,
      [&](int r0, uint32_t* v) {
        fame::split_baseconv<LOGC>(v, yj, na, N, n, r0, wr, id, dm, q, qn);
      },
      [&](int i, uint32_t val) { o[i] = val; });
}

}  // namespace

// the kernel by log2 of the cluster size
const decltype(&bc_ntt_split<0>) kBcNtt[] = {
    bc_ntt_split<0>, bc_ntt_split<1>, bc_ntt_split<2>, bc_ntt_split<3>,
    bc_ntt_split<4>};

// y: the (B, nq, N) intt_scale output; c1 the passthrough, read in place
extern "C" int hoist_bc_ntt_launch(const uint32_t* y, const uint32_t* c1,
                                   long long c1_bstride, uint32_t* out, int B,
                                   int nbeta, int alpha, int nq, int M,
                                   int logN, int logc, const uint32_t* w,
                                   const uint32_t* dmod, const double* inv_d,
                                   const uint32_t* psi, const uint32_t* q32,
                                   const uint32_t* qneg, const uint32_t* mask,
                                   void* stream) {
  if (!fame::split_shape_ok(logN, logc))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fame::launch_split(
      kBcNtt[logc], logc, B * nbeta, M, logN,
      static_cast<cudaStream_t>(stream), y, nq, c1, c1_bstride, out, nbeta,
      alpha, M, logN, w, dmod, inv_d, psi, q32, qneg, mask));
}

// y: (nbeta·alpha, N), a short digit's padded rows zero (they carry zero
// w and inv_d too, so they contribute exactly zero); pt: (M, N)
extern "C" int baseconv_ntt_launch(const uint32_t* y, const uint32_t* pt,
                                   uint32_t* out, int nbeta, int alpha, int M,
                                   int logN, int logc, const uint32_t* w,
                                   const uint32_t* dmod, const double* inv_d,
                                   const uint32_t* psi, const uint32_t* q32,
                                   const uint32_t* qneg, const uint32_t* mask,
                                   void* stream) {
  if (!fame::split_shape_ok(logN, logc))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fame::launch_split(
      kBcNtt[logc], logc, nbeta, M, logN, static_cast<cudaStream_t>(stream),
      y, nbeta * alpha, pt, 0LL, out, nbeta, alpha, M, logN, w, dmod, inv_d,
      psi, q32, qneg, mask));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
