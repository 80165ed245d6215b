// Shared device routines of the port's kernels: u32 Montgomery arithmetic
// (R = 2^32), the HPS BaseConv of a few coefficient rows, and the split
// negacyclic transforms that spread one row over a thread-block cluster,
// with their launcher (ntt.cu, intt_scale.cu, hoist.cu, moddown.cu).  No
// kernel holds a whole row in one block: a block holds one chunk and its
// twiddles, 33 KB for a 2^15 row over 8 blocks, 66 KB for a 2^16 row.
//
// montmul computes what repro/core/modmath.py montmul computes, a·b·2^-32
// mod q as the canonical residue in [0, q), for any a·b < q·2^32 (residues
// below 2^30: every modulus is a prime below 2^30).  It reduces the other
// way round: with m = lo·q^-1 (q^-1 = −qneg mod 2^32) the low words of x
// and m·q cancel, so (x − m·q)/2^32 = hi − umulhi(m, q) exactly, in
// (−q, q), and one conditional add makes it canonical.  The reference adds
// m·q with m = lo·(−q^-1) and subtracts q once; both end in the one
// canonical residue, so the outputs are equal bit for bit.  Each
// conditional add or subtract is an unsigned min (min(t, t − q) is t − q
// exactly when t >= q), one add-and-min instruction on Hopper.
#pragma once
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace fame {

__device__ __forceinline__ uint32_t montmul(uint32_t a, uint32_t b, uint32_t q,
                                            uint32_t qneg) {
  const unsigned long long x = static_cast<unsigned long long>(a) * b;
  const uint32_t m = static_cast<uint32_t>(x) * (0u - qneg);   // x·q^-1
  const uint32_t t = static_cast<uint32_t>(x >> 32) - __umulhi(m, q);
  return min(t, t + q);                 // (−q, q) -> [0, q)
}

__device__ __forceinline__ uint32_t montadd(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;
  return min(s, s - q);
}

__device__ __forceinline__ uint32_t montsub(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t d = a + q - b;
  return min(d, d - q);
}

// HPS floor correction term y * inv_d, accumulated without FMA contraction
// so the rounding is that of the reference's separate multiply and add.
__device__ __forceinline__ double fmac_nofuse(double acc, uint32_t y, double inv_d) {
  return __dadd_rn(acc, __dmul_rn(static_cast<double>(y), inv_d));
}

__device__ __forceinline__ uint32_t floor_count(double s) {
  return static_cast<uint32_t>(floor(__dadd_rn(s, 0.5e-6)));
}

// The HPS BaseConv of nd coefficient rows y (row i at y + i·N) onto one
// target limb (Montgomery weights w[i], float64 inv_d[i], D mod q dm) at
// the C positions a·n + r0, a < C, into v: the arithmetic of the
// reference's fused kernels — the float64 floor count __dmul_rn for i = 0,
// then multiply and add rounded apart in ascending i, floor(s + 0.5e-6);
// the Montgomery sum beside it.  Drop row (or digit row) outside and a
// inside, so C loads are in flight; the reads are coalesced across r0.
template <int LOGC>
__device__ __forceinline__ void split_baseconv(uint32_t* v,
                                               const uint32_t* __restrict__ y,
                                               int nd, long long N, int n,
                                               int r0,
                                               const uint32_t* __restrict__ w,
                                               const double* __restrict__ inv_d,
                                               uint32_t dm, uint32_t q,
                                               uint32_t qn) {
  double fs[1 << LOGC];
#pragma unroll
  for (int a = 0; a < (1 << LOGC); ++a) v[a] = 0u;
  for (int i = 0; i < nd; ++i) {
    const uint32_t* yi = y + i * N + r0;
    const uint32_t wi = w[i];
    const double di = inv_d[i];
#pragma unroll
    for (int a = 0; a < (1 << LOGC); ++a) {
      const uint32_t yv = yi[a * n];
      fs[a] = i == 0 ? __dmul_rn(static_cast<double>(yv), di)
                     : fmac_nofuse(fs[a], yv, di);
      v[a] = montadd(v[a], montmul(yv, wi, q, qn), q);
    }
  }
#pragma unroll
  for (int a = 0; a < (1 << LOGC); ++a)
    v[a] = montsub(v[a], montmul(floor_count(fs[a]), dm, q, qn), q);
}

// ---------------------------------------------------------------------------
// Split transforms: one row of N = 2^logN values over a thread-block
// cluster of C = 2^c blocks (split_fwd_row: ntt.cu, hoist.cu, moddown.cu;
// split_inv_row: ntt.cu, intt_scale.cu; all launch through launch_split).
// Write a row index j = a·n + r with n = N/C the chunk length, a < C the
// chunk and r < n the offset in it.  The forward transform (Cooley–Tukey,
// natural -> bit-reversed order) and the inverse (Gentleman–Sande back)
// run the butterflies of ntt_mont_raw / intt_mont_raw (repro/core/ntt.py)
// in another order, so the output is the same bit for bit.
//
// * Cross stages: the first c Cooley–Tukey stages (t = N/2 … n), or the
//   last c Gentleman–Sande ones, pair indices of equal r; their twiddle
//   depends only on a's top bits (C − 1 values).  The cluster's block of
//   rank k owns the r-range [k·R, (k+1)·R), R = n/C, and runs them in
//   registers, one r (C values) a thread at a time.
// * Local stages: the other log2(n), on one chunk in one block's shared
//   memory, with the global twiddle index 2^lm + a·2^(lm−c) + local group.
//   The n − 1 twiddles chunk a needs are copied once into shared memory
//   (split_load_twiddles), laid out as an n-point table, so a stage of 2^σ
//   local groups reads [2^σ, 2^(σ+1)).  Each thread holds 2^P values
//   (P ≤ 3) and runs P stages on them between two shared-memory round
//   trips: a pass.
// * Exchange: between the two, each value moves to the shared memory of
//   the block that needs it next through distributed shared memory
//   (cooperative_groups' map_shared_rank), fenced by cluster barriers.
//
// Shared memory holds n values at padded index split_pad(i), one spare
// word every 32, so that a pass that gives each thread 8 neighbouring
// values (t = 1, 2, 4) reads them without bank conflicts; then the n-point
// twiddle table.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int split_pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Cross Cooley–Tukey stages lm = 0 … c−1 on v[a], a < C (one r).
template <int LOGC>
__device__ __forceinline__ void split_cross_fwd(uint32_t* v,
                                                const uint32_t* __restrict__ psi,
                                                uint32_t q, uint32_t qneg) {
#pragma unroll
  for (int lm = 0; lm < LOGC; ++lm) {
    const int half = (1 << LOGC) >> (lm + 1);
#pragma unroll
    for (int g = 0; g < (1 << lm); ++g) {
      const uint32_t w = __ldg(psi + (1 << lm) + g);
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const int a0 = g * 2 * half + k, a1 = a0 + half;
        const uint32_t x0 = v[a0], x1 = montmul(v[a1], w, q, qneg);
        v[a0] = montadd(x0, x1, q);
        v[a1] = montsub(x0, x1, q);
      }
    }
  }
}

// Cross Gentleman–Sande stages (h = C/2 … 1 groups) on v[a], a < C.
template <int LOGC>
__device__ __forceinline__ void split_cross_inv(uint32_t* v,
                                                const uint32_t* __restrict__ psii,
                                                uint32_t q, uint32_t qneg) {
#pragma unroll
  for (int bit = 0; bit < LOGC; ++bit) {
    const int half = 1 << bit, groups = (1 << LOGC) >> (bit + 1);
#pragma unroll
    for (int g = 0; g < groups; ++g) {
      const uint32_t w = __ldg(psii + groups + g);
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const int a0 = g * 2 * half + k, a1 = a0 + half;
        const uint32_t x0 = v[a0], x1 = v[a1];
        v[a0] = montadd(x0, x1, q);
        v[a1] = montmul(montsub(x0, x1, q), w, q, qneg);
      }
    }
  }
}

// Chunk a's twiddles into tws[1 … n): the local table index i of stage
// σ = log2(i) holds the global psi[2^(c+σ) + a·2^σ + (i − 2^σ)], for the
// forward and the inverse tables alike.  Each thread starts its (at most
// 8: 8·blockDim >= n, split_threads) loads before it stores any, so they
// are in flight together.  The caller synchronises.
__device__ __forceinline__ void split_load_twiddles(
    uint32_t* tws, int n, int c, int a, const uint32_t* __restrict__ psi) {
  uint32_t t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = threadIdx.x + e * blockDim.x;
    if (i >= 1 && i < n)
      t[e] = __ldg(psi + i + (((1 << c) + a - 1) << (31 - __clz(i))));
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = threadIdx.x + e * blockDim.x;
    if (i >= 1 && i < n) tws[i] = t[e];
  }
}

// One forward pass over a chunk (length n = 2^ln; tws its twiddle table):
// local stages s0 … s0+P−1, i.e. the P index bits ln−s0−1 … b = ln−s0−P.
// A unit u is the 2^P indices (hi << (b+P)) | (e << b) | lo, e < 2^P.  In
// place in s.
template <int P>
__device__ void split_pass_fwd(uint32_t* s, const uint32_t* tws, int ln,
                               int s0, uint32_t q, uint32_t qneg) {
  const int b = ln - s0 - P;
  for (int u = threadIdx.x; u < (1 << (ln - P)); u += blockDim.x) {
    const int lo = u & ((1 << b) - 1), hi = u >> b;
    const int base = (hi << (b + P)) | lo;
    uint32_t v[1 << P];
#pragma unroll
    for (int e = 0; e < (1 << P); ++e) v[e] = s[split_pad(base | (e << b))];
#pragma unroll
    for (int st = 0; st < P; ++st) {
      const int half = 1 << (P - 1 - st);
      const uint32_t* tw = tws + (1 << (s0 + st)) + (hi << st);
#pragma unroll
      for (int g = 0; g < (1 << st); ++g) {
        const uint32_t w = tw[g];
#pragma unroll
        for (int k = 0; k < half; ++k) {
          const int e0 = g * 2 * half + k, e1 = e0 + half;
          const uint32_t x0 = v[e0], x1 = montmul(v[e1], w, q, qneg);
          v[e0] = montadd(x0, x1, q);
          v[e1] = montsub(x0, x1, q);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < (1 << P); ++e) s[split_pad(base | (e << b))] = v[e];
  }
}

// Every local forward stage of a chunk: a first pass of 1–3 stages, then
// passes of 3, the last on bits 2 … 0.  Ends with the chunk complete.
__device__ void split_local_fwd(uint32_t* s, const uint32_t* tws, int ln,
                                uint32_t q, uint32_t qneg) {
  int s0 = 0;
  for (int P = (ln - 1) % 3 + 1; s0 < ln; s0 += P, P = 3) {
    if (P == 1) split_pass_fwd<1>(s, tws, ln, s0, q, qneg);
    else if (P == 2) split_pass_fwd<2>(s, tws, ln, s0, q, qneg);
    else split_pass_fwd<3>(s, tws, ln, s0, q, qneg);
    __syncthreads();
  }
}

// The inverse pass on bits b … b+P−1 (t = 2^b … 2^(b+P−1)) of the unit
// u of a chunk (tws its twiddle table); v holds the unit's 2^P values in
// and out.
template <int P>
__device__ __forceinline__ void split_unit_inv(uint32_t* v, const uint32_t* tws,
                                               int ln, int b, int u, uint32_t q,
                                               uint32_t qneg) {
  const int hi = u >> b;
#pragma unroll
  for (int st = 0; st < P; ++st) {
    const int half = 1 << st;
    const uint32_t* tw = tws + (1 << (ln - b - st - 1)) + (hi << (P - st - 1));
#pragma unroll
    for (int g = 0; g < (1 << (P - st - 1)); ++g) {
      const uint32_t w = tw[g];
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const int e0 = g * 2 * half + k, e1 = e0 + half;
        const uint32_t x0 = v[e0], x1 = v[e1];
        v[e0] = montadd(x0, x1, q);
        v[e1] = montmul(montsub(x0, x1, q), w, q, qneg);
      }
    }
  }
}

template <int P>
__device__ void split_pass_inv(uint32_t* s, const uint32_t* tws, int ln, int b,
                               uint32_t q, uint32_t qneg) {
  for (int u = threadIdx.x; u < (1 << (ln - P)); u += blockDim.x) {
    const int base = ((u >> b) << (b + P)) | (u & ((1 << b) - 1));
    uint32_t v[1 << P];
#pragma unroll
    for (int e = 0; e < (1 << P); ++e) v[e] = s[split_pad(base | (e << b))];
    split_unit_inv<P>(v, tws, ln, b, u, q, qneg);
#pragma unroll
    for (int e = 0; e < (1 << P); ++e) s[split_pad(base | (e << b))] = v[e];
  }
}

// The local inverse stages of a chunk but the last pass (bits ln−3 …
// ln−1, which the caller runs with split_unit_inv<3> into registers): a
// first pass of 1–3 stages on bits 0 …, then passes of 3.  Needs ln >= 3.
__device__ void split_local_inv(uint32_t* s, const uint32_t* tws, int ln,
                                uint32_t q, uint32_t qneg) {
  int b = 0;
  for (int P = (ln - 1) % 3 + 1; b < ln - 3; b += P, P = 3) {
    if (P == 1) split_pass_inv<1>(s, tws, ln, b, q, qneg);
    else if (P == 2) split_pass_inv<2>(s, tws, ln, b, q, qneg);
    else split_pass_inv<3>(s, tws, ln, b, q, qneg);
    __syncthreads();
  }
}

// One row's forward split transform on the calling block's cluster (grid
// x = row << LOGC, so the cluster is one row; psi its twiddle row).  The
// row's values come from load(r0, v): v[a] = value at a·n + r0 for a < C,
// r0 in the block's r-range [k·R, (k+1)·R), so a caller can compute them
// in registers (split_baseconv in hoist.cu and moddown.cu) instead of
// reading them.  After the
// local stages, store(j, value) receives the transformed row at j = k·n +
// i, i < n: chunk k, k the block's rank.
template <int LOGC, typename Load, typename Store>
__device__ __forceinline__ void split_fwd_row(uint32_t* s, int logN,
                                              const uint32_t* __restrict__ psi,
                                              uint32_t q, uint32_t qn, Load load,
                                              Store store) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.block_rank());
  const int ln = logN - LOGC, n = 1 << ln, R = n >> LOGC;

  // every block of the cluster must be running before its shared memory
  // is written: arrive, copy the chunk's twiddles, wait
  cluster_arrive_relaxed();
  uint32_t* tws = s + n + (n >> 5);
  split_load_twiddles(tws, n, LOGC, k, psi);
  cluster_wait();
  for (int u = threadIdx.x; u < R; u += blockDim.x) {
    uint32_t v[1 << LOGC];
    load(k * R + u, v);
    split_cross_fwd<LOGC>(v, psi, q, qn);
#pragma unroll
    for (int a = 0; a < (1 << LOGC); ++a)
      cluster.map_shared_rank(s, a)[split_pad(k * R + u)] = v[a];
  }
  cluster.sync();                       // chunk k is complete in block k

  split_local_fwd(s, tws, ln, q, qn);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    store((k << ln) + i, s[split_pad(i)]);
}

// One row's inverse split transform on the calling block's cluster (grid
// x = row << LOGC; psii its twiddle row), the mirror of split_fwd_row:
// load(j) gives the row's value at j = k·n + i, i < n (chunk k, k the
// block's rank), so a caller reads it in place through a batch stride or
// a row table.  Block k runs the local stages on chunk k (the last pass
// held in registers across a cluster barrier), scatters each value to the
// block owning its r, and that block runs the c cross stages; then
// store(j, value) receives the row's value at j = a·n + r for a < C and r
// in the block's r-range [k·R, (k+1)·R), before any N^-1 factor, which
// the caller folds into its epilogue.  Needs ln >= 3.
template <int LOGC, typename Load, typename Store>
__device__ __forceinline__ void split_inv_row(uint32_t* s, int logN,
                                              const uint32_t* __restrict__ psii,
                                              uint32_t q, uint32_t qn, Load load,
                                              Store store) {
  namespace cg = cooperative_groups;
  constexpr int C = 1 << LOGC;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.block_rank());
  const int ln = logN - LOGC, n = 1 << ln, R = n >> LOGC;

  // chunk k and its twiddles: load (each thread's 8 loads in flight
  // together), then every local stage but the last pass
  uint32_t* tws = s + n + (n >> 5);
  {
    uint32_t x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = threadIdx.x + e * blockDim.x;
      if (i < n) x[e] = load((k << ln) + i);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = threadIdx.x + e * blockDim.x;
      if (i < n) s[split_pad(i)] = x[e];
    }
  }
  split_load_twiddles(tws, n, LOGC, k, psii);
  __syncthreads();
  split_local_inv(s, tws, ln, q, qn);
  const int b3 = ln - 3, u = threadIdx.x;
  uint32_t v[8];
  if (u < (1 << b3)) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = s[split_pad((e << b3) | u)];
    split_unit_inv<3>(v, tws, ln, b3, u, q, qn);
  }
  cluster.sync();                     // every block is done with its chunk
  if (u < (1 << b3)) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = (e << b3) | u;    // to the owner of r, segment k
      cluster.map_shared_rank(s, r >> (ln - LOGC))[split_pad(
          k * R + (r & (R - 1)))] = v[e];
    }
  }
  cluster.sync();                     // block k holds all C segments of its r

  for (int w = threadIdx.x; w < R; w += blockDim.x) {
    uint32_t c[C];
#pragma unroll
    for (int a = 0; a < C; ++a) c[a] = s[split_pad(a * R + w)];
    split_cross_inv<LOGC>(c, psii, q, qn);
#pragma unroll
    for (int a = 0; a < C; ++a) store(a * n + k * R + w, c[a]);
  }
}

// Threads per block of a split transform of chunk length n: one thread per
// 8-value unit (the inverse holds its last pass in registers across the
// exchange), at least one warp.
inline int split_threads(int n) { return n >= 256 ? n / 8 : 32; }

// The padded chunk, then its twiddle table.
inline size_t split_smem_bytes(int n) {
  return sizeof(uint32_t) * static_cast<size_t>(2 * n + (n >> 5));
}

// A cluster of 2^logc blocks (at most 16) over chunks of n = 2^(logN -
// logc) values: at least 8 values a chunk (the last pass), at least one r
// a block in the cross stages (n >= C), at most n/8 = 1024 threads.
inline bool split_shape_ok(int logN, int logc) {
  const int ln = logN - logc;
  return logc >= 0 && logc <= 4 && ln >= 3 && ln >= logc && ln <= 13;
}

// Launch a split kernel over B × M rows of 2^logN: grid (M << logc, B),
// one cluster of 2^logc blocks a row, the rows of one batch element
// adjacent; 16 blocks opt into the non-portable cluster size, and a chunk
// above 48 KB into more dynamic shared memory.  Returns the launch error.
template <typename Kernel, typename... Args>
cudaError_t launch_split(Kernel kernel, int logc, int B, int M, int logN,
                         cudaStream_t stream, Args... args) {
  const int n = 1 << (logN - logc);
  const size_t smem = split_smem_bytes(n);
  if (logc > 3) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (smem > 48 * 1024) {               // n = 8192: a 2^16 row over 8 blocks
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << logc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(M) << logc, B);
  cfg.blockDim = dim3(split_threads(n));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace fame
