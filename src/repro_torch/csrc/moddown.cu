// moddown_finish: the tail of the merged ModDown+Rescale — HPS BaseConv from
// the nd scaled drop-basis rows onto one target limb (float64 floor
// correction), forward NTT, then (x − conv) · P^-1.
//
// Replaces: src/repro/kernels/basechange.py:moddown_finish (the TPU kernel,
// grid over target rows of one polynomial, the nd drop rows resident).
//
// Bound on an H100: bytes.  Per polynomial it reads the nd drop rows once
// (at the Step-2 shape, 9 rows of 128 KiB per polynomial), the R target
// rows and the twiddles, and writes the R output rows; the BaseConv is nd
// Montgomery MACs and nd float64 MACs per output value, the NTT N/2·log2 N
// Montgomery products per row, both below the card's rates.
//
// Design: one (target row r, polynomial p) row per thread-block cluster of
// C = 2^c blocks (C from the rows of the launch and N, as ntt's:
// kernels/ntt.py cluster_size; 1-16), the forward split transform of common.cuh
// (split_fwd_row, as ntt.cu) with the BaseConv fused in front and the
// epilogue behind:
// * prologue, in registers: block k's thread for offset r0 of its r-range
//   computes the C values at j = a·n + r0 (n = N/C, a < C) straight from
//   y[p] (common.cuh split_baseconv: the Montgomery sum over i of
//   y·w[r, i] and the float64 floor count of Σ y·inv_d[i], with the
//   arithmetic of the reference's fused kernel) — reads coalesced across r0;
// * those C values go through the c cross NTT stages in registers and then,
//   through distributed shared memory, to the block of their chunk;
// * each block runs the local stages on its chunk and writes it once as
//   (x[p, r, j] − conv[j]) · P^-1, reading x[p, r] through its batch stride.
// No row is ever held in one block, so logN 16 fits (a 2^16 row over 8
// blocks is 66 KB a block).  The grid is (R << c, P): the clusters of one
// polynomial's R target rows are adjacent, so its nd drop rows, which each
// of them reads, stay in L2 between them.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md
// §6): the Set-B Step-2 launch (512 polynomials × 14 target rows, nd = 9)
// takes ~5.0 ms at C = 8 (6.0 at C = 4, 8.9 at C = 16; one block a row
// before: 10.9) against a byte bound of 0.74 ms.  What holds it: the split
// NTT over those 7168 rows alone takes ~2.3 ms, and with one drop row
// instead of nine the launch takes ~3.4 ms, so the BaseConv's per-row
// Montgomery and float64 work is most of the rest; the L2 reads of y are
// not (the clusters of one polynomial find its rows in L2).
#include "common.cuh"

namespace {

template <int LOGC>
__global__ void __launch_bounds__(1024)
    moddown_split(const uint32_t* __restrict__ x, long long x_bstride,
                  const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                  int R, int nd, int logN, const uint32_t* __restrict__ w,
                  const uint32_t* __restrict__ dmod,
                  const double* __restrict__ inv_d,
                  const uint32_t* __restrict__ psi,
                  const uint32_t* __restrict__ p_inv,
                  const uint32_t* __restrict__ q32,
                  const uint32_t* __restrict__ qneg) {
  extern __shared__ uint32_t s[];
  const int r = blockIdx.x >> LOGC;
  const long long p = blockIdx.y;
  const long long N = 1LL << logN;
  const int n = 1 << (logN - LOGC);
  const uint32_t q = q32[r], qn = qneg[r];
  const uint32_t* yp = y + p * nd * N;
  const uint32_t* wr = w + static_cast<long long>(r) * nd;
  const uint32_t dm = dmod[r], pi = p_inv[r];
  const uint32_t* xr = x + p * x_bstride + r * N;
  uint32_t* o = out + (p * R + r) * N;
  fame::split_fwd_row<LOGC>(
      s, logN, psi + r * N, q, qn,
      [&](int r0, uint32_t* v) {          // BaseConv_r at a·n + r0, a < C
        fame::split_baseconv<LOGC>(v, yp, nd, N, n, r0, wr, inv_d, dm, q, qn);
      },
      [&](int j, uint32_t conv) {
        o[j] = fame::montmul(fame::montsub(xr[j], conv, q), pi, q, qn);
      });
}

}  // namespace

// the kernel by log2 of the cluster size
const decltype(&moddown_split<0>) kModdown[] = {
    moddown_split<0>, moddown_split<1>, moddown_split<2>, moddown_split<3>,
    moddown_split<4>};

extern "C" int moddown_finish_launch(const uint32_t* x, long long x_bstride,
                                     const uint32_t* y, uint32_t* out, int P,
                                     int R, int nd, int logN, int logc,
                                     const uint32_t* w, const uint32_t* dmod,
                                     const double* inv_d, const uint32_t* psi,
                                     const uint32_t* p_inv,
                                     const uint32_t* q32,
                                     const uint32_t* qneg, void* stream) {
  if (!fame::split_shape_ok(logN, logc))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fame::launch_split(
      kModdown[logc], logc, P, R, logN, static_cast<cudaStream_t>(stream), x,
      x_bstride, y, out, R, nd, logN, w, dmod, inv_d, psi, p_inv, q32, qneg));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
