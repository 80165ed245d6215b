// baseconv: standalone HPS fast base conversion from a source basis S to a
// target basis T on the u32 Montgomery datapath, with the TPU kernel's
// float32 overflow correction:
//   y_i = montmul(x_i, q̂_i^-1)                      (per source limb i)
//   v   = floor(Σ_i f32(y_i)·f32(1/q_i) + 0.5e-6)    (f32, i ascending)
//   out_t = Σ_i montmul(y_i, W[t, i]) − montmul(v, D mod t)   (mod t)
//
// Replaces: src/repro/kernels/baseconv.py:baseconv (the TPU kernel, grid
// (|T|, N / block): each step loads all |S| source rows of a coefficient
// tile and emits one target-limb tile).
//
// Bound on an H100: bytes.  Per coefficient it reads |S| source words and
// writes |T|, against |S| + |S|·|T| + |T| Montgomery products.  At the
// Set-B shapes (8 -> 16, 9 -> 15 at N = 2^15) the byte bound, ~0.94 µs,
// is below what one launch costs (1.2 µs under a CUDA graph on an NVIDIA
// H100 80GB HBM3 at 700 W, tools/baseconv_compare.py), so the design cuts
// the integer work and the round trips a block waits on.
// Grid: one block of 256 threads a tile of kTile coefficients, all targets.
//   1. y for the tile's |S| x kTile words, once per block, into shared
//      memory: each thread loads four neighbouring coefficients of a source
//      row (16 bytes).  The block's constants (the f32 1/q, the W rows,
//      q_t, q_t^-1, 2^32 mod q_t) are staged in one round of loads
//      issued behind those, so the block waits on one L2 round trip.  The
//      per-source q̂^-1, q, qneg are read where they are used (one address
//      a warp).
//   2. v, once per coefficient, one thread a coefficient, into row |S| of
//      the y tile.
//   3. For two targets and four neighbouring coefficients a thread: the
//      mod-t sum Σ_i y_i·W[t, i] − v·(D mod t) as Σ_i y_i·W[t, i] +
//      v·(q_t − D mod t), the v row being one more source row, in 64-bit
//      sums of up to kChunk products, each folded once (two Montgomery
//      reductions) where the reference spends a montmul and a modular add
//      a product; 16-byte stores.  Each y row read from shared memory
//      serves both targets.
// With 128-coefficient tiles a ring of N >= 2^14 already gives every SM a
// block.  N that is not a multiple of 4 (rows not 16-byte aligned) loads
// and stores word by word; a partial last tile masks its columns.
//
// The correction decides bits: with 28–30-bit primes each term is < 1 and
// the f32 error of a sum over |S| = 9 terms (~5e-7) is the size of the
// epsilon, so v can move by one with the order or the rounding of the sum.
// The kernel therefore sums left to right over i with __fmul_rn/__fadd_rn
// (no FMA contraction), converts 1/q with __double2float_rn and y with
// __uint2float_rn, as the plain version in kernels/baseconv.py does.  The
// mod-t sums are exact, so their order and grouping change no bit.  The
// float64 oracle (kernels/ref.py baseconv_ref) may differ from both.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;              // coefficients a block
constexpr int kQuads = kTile / 4;       // 16-byte columns of a tile
constexpr int kUnroll = 4;              // source loads in flight a thread
constexpr int kChunk = 12;              // products a 64-bit sum (see fold)

// z·2^-32 mod q, canonical, for z < 12·2^60 (a sum of kChunk products of
// 30-bit residues); qinv = q^-1 mod 2^32, rq = 2^32 mod q.  montmul's
// reduction leaves t = (z − m·q)/2^32 in (−q, z/2^32], so t + q lies in
// (0, 2^32) and one more reduction of (t + q)·rq < q·2^32 makes it
// canonical.
__device__ __forceinline__ uint32_t fold(unsigned long long z, uint32_t q,
                                         uint32_t qinv, uint32_t rq) {
  const uint32_t m = static_cast<uint32_t>(z) * qinv;
  const uint32_t t = static_cast<uint32_t>(z >> 32) + q - __umulhi(m, q);
  const unsigned long long u = static_cast<unsigned long long>(t) * rq;
  const uint32_t m2 = static_cast<uint32_t>(u) * qinv;
  const uint32_t t2 = static_cast<uint32_t>(u >> 32) - __umulhi(m2, q);
  return min(t2, t2 + q);
}

template <bool VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ row, int j,
                                       int N) {
  if (VEC && j + 3 < N) return __ldg(reinterpret_cast<const uint4*>(row + j));
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (j < N) v.x = __ldg(row + j);
  if (j + 1 < N) v.y = __ldg(row + j + 1);
  if (j + 2 < N) v.z = __ldg(row + j + 2);
  if (j + 3 < N) v.w = __ldg(row + j + 3);
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(uint32_t* __restrict__ row, int j,
                                       int N, uint4 v) {
  if (VEC && j + 3 < N) {
    *reinterpret_cast<uint4*>(row + j) = v;
    return;
  }
  if (j < N) row[j] = v.x;
  if (j + 1 < N) row[j + 1] = v.y;
  if (j + 2 < N) row[j + 2] = v.z;
  if (j + 3 < N) row[j + 3] = v.w;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
baseconv_kernel(const uint32_t* __restrict__ x,
                const uint32_t* __restrict__ hat_inv,
                const uint32_t* __restrict__ q_own,
                const uint32_t* __restrict__ qneg_own,
                const uint32_t* __restrict__ w,
                const uint32_t* __restrict__ d_mod,
                const double* __restrict__ inv_d,
                const uint32_t* __restrict__ q_gen,
                const uint32_t* __restrict__ qneg_gen,
                uint32_t* __restrict__ out, int S, int T, int N) {
  // shared: y (S + 1, kTile) with v as row S; W (S + 1, T2), row i
  // holding W[t, i] of every target t (row S: q_t − D mod t), T2 = T
  // rounded up to pairs (the pad repeats the last target); q_t, q_t^-1,
  // 2^32 mod q_t (T2 each); f32 1/q (S)
  extern __shared__ uint4 sm4[];
  const int t2 = (T + 1) & ~1;
  uint32_t* s_y = reinterpret_cast<uint32_t*>(sm4);
  uint32_t* s_w = s_y + (S + 1) * kTile;
  uint32_t* s_qt = s_w + (S + 1) * t2;
  uint32_t* s_qi = s_qt + t2;
  uint32_t* s_rq = s_qi + t2;
  float* s_inv = reinterpret_cast<float*>(s_rq + t2);

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kTile;
  const int n_items = S * kQuads;

  // 1. y, 16 bytes a load; the constants staged behind the first loads
  for (int base = 0; base == 0 || base < n_items;
       base += kUnroll * kThreads) {
    uint4 xv[kUnroll];
    uint32_t h[kUnroll], q[kUnroll], qn[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int it = base + u * kThreads + tid;
      if (it < n_items) {
        const int i = it / kQuads;
        xv[u] = load4<VEC>(x + static_cast<long long>(i) * N,
                           j0 + 4 * (it % kQuads), N);
        h[u] = __ldg(hat_inv + i);
        q[u] = __ldg(q_own + i);
        qn[u] = __ldg(qneg_own + i);
      }
    }
    if (base == 0) {                    // every load of a round, then its stores
      const int n_w = (S + 1) * t2;
      for (int k = tid; k < max(n_w, max(S, t2)); k += kThreads) {
        const int i = k / t2, t = min(k % t2, T - 1);
        const int tq = min(k, T - 1);
        double inv = 0.0;
        uint32_t wv = 0u, qt = 1u, qnt = 0u;
        if (k < S) inv = inv_d[k];
        if (k < n_w)
          wv = i < S ? w[static_cast<long long>(t) * S + i]
                     : q_gen[t] - d_mod[t];
        if (k < t2) {
          qt = q_gen[tq];
          qnt = qneg_gen[tq];
        }
        if (k < S) s_inv[k] = __double2float_rn(inv);
        if (k < n_w) s_w[k] = wv;
        if (k < t2) {
          s_qt[k] = qt;
          s_qi[k] = 0u - qnt;
          s_rq[k] = (0u - qt) % qt;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int it = base + u * kThreads + tid;
      if (it < n_items)
        reinterpret_cast<uint4*>(s_y)[it] =
            make_uint4(fame::montmul(xv[u].x, h[u], q[u], qn[u]),
                       fame::montmul(xv[u].y, h[u], q[u], qn[u]),
                       fame::montmul(xv[u].z, h[u], q[u], qn[u]),
                       fame::montmul(xv[u].w, h[u], q[u], qn[u]));
    }
  }
  __syncthreads();

  // 2. v, once a coefficient: i ascending, multiply and add rounded apart
  for (int j = tid; j < kTile; j += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < S; ++i)
      s = __fadd_rn(s, __fmul_rn(__uint2float_rn(s_y[i * kTile + j]),
                                 s_inv[i]));
    s_y[S * kTile + j] = static_cast<uint32_t>(floorf(__fadd_rn(s, 0.5e-6f)));
  }
  __syncthreads();

  // 3. out_t = (Σ_i y_i·W[t, i] + v·(q_t − D mod t))·2^-32 mod q_t for the
  //    targets, two targets and four coefficients a thread
  const uint4* s_y4 = reinterpret_cast<const uint4*>(s_y);
  const uint2* s_w2 = reinterpret_cast<const uint2*>(s_w);
  for (int it = tid; it < (t2 / 2) * kQuads; it += kThreads) {
    const int tp = it / kQuads, c = it % kQuads;
    const int j = j0 + 4 * c;
    if (j >= N) continue;
    const uint32_t qa = s_qt[2 * tp], qia = s_qi[2 * tp], rqa = s_rq[2 * tp];
    const uint32_t qb = s_qt[2 * tp + 1], qib = s_qi[2 * tp + 1];
    const uint32_t rqb = s_rq[2 * tp + 1];
    uint4 ra = make_uint4(0u, 0u, 0u, 0u), rb = ra;
    for (int i0 = 0; i0 <= S; i0 += kChunk) {
      const int ie = min(i0 + kChunk, S + 1);
      unsigned long long a0 = 0ull, a1 = 0ull, a2 = 0ull, a3 = 0ull;
      unsigned long long b0 = 0ull, b1 = 0ull, b2 = 0ull, b3 = 0ull;
#pragma unroll 4
      for (int i = i0; i < ie; ++i) {
        const uint4 y = s_y4[i * kQuads + c];
        const uint2 wi = s_w2[i * (t2 / 2) + tp];
        a0 += static_cast<unsigned long long>(y.x) * wi.x;
        a1 += static_cast<unsigned long long>(y.y) * wi.x;
        a2 += static_cast<unsigned long long>(y.z) * wi.x;
        a3 += static_cast<unsigned long long>(y.w) * wi.x;
        b0 += static_cast<unsigned long long>(y.x) * wi.y;
        b1 += static_cast<unsigned long long>(y.y) * wi.y;
        b2 += static_cast<unsigned long long>(y.z) * wi.y;
        b3 += static_cast<unsigned long long>(y.w) * wi.y;
      }
      ra.x = fame::montadd(ra.x, fold(a0, qa, qia, rqa), qa);
      ra.y = fame::montadd(ra.y, fold(a1, qa, qia, rqa), qa);
      ra.z = fame::montadd(ra.z, fold(a2, qa, qia, rqa), qa);
      ra.w = fame::montadd(ra.w, fold(a3, qa, qia, rqa), qa);
      rb.x = fame::montadd(rb.x, fold(b0, qb, qib, rqb), qb);
      rb.y = fame::montadd(rb.y, fold(b1, qb, qib, rqb), qb);
      rb.z = fame::montadd(rb.z, fold(b2, qb, qib, rqb), qb);
      rb.w = fame::montadd(rb.w, fold(b3, qb, qib, rqb), qb);
    }
    uint32_t* row = out + static_cast<long long>(2 * tp) * N;
    store4<VEC>(row, j, N, ra);
    if (2 * tp + 1 < T) store4<VEC>(row + N, j, N, rb);
  }
}

}  // namespace

// x (S, N); hat_inv / q_own / qneg_own (S, 1); w (T, S) Montgomery;
// d_mod / q_gen / qneg_gen (T, 1); inv_d (S, 1) float64 -> out (T, N).
extern "C" int baseconv_launch(const uint32_t* x, const uint32_t* hat_inv,
                               const uint32_t* q_own, const uint32_t* qneg_own,
                               const uint32_t* w, const uint32_t* d_mod,
                               const double* inv_d, const uint32_t* q_gen,
                               const uint32_t* qneg_gen, uint32_t* out, int S,
                               int T, int N, void* stream) {
  if (N <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const int tiles = (N + kTile - 1) / kTile;
  const size_t t2 = (T + 1) & ~1;
  const size_t smem = ((S + 1) * (kTile + t2) + 3 * t2 + S) * sizeof(uint32_t);
  const bool vec = N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  auto kernel = vec ? baseconv_kernel<true> : baseconv_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, hat_inv, q_own, qneg_own, w, d_mod, inv_d, q_gen, qneg_gen, out, S,
      T, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
