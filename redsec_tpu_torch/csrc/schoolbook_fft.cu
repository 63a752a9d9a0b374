// The schoolbook CMUX round for Hopper (sm_90a) through exact float64
// transforms, bound to PyTorch with ctypes
// (redsec_tpu_torch/crypto/kernels.py::schoolbook_round).
//
// One launch is one whole CMUX round of the parameter sets without NTT primes
// (N >= 4096: medium, large, medium_v2, large_v2), and of any set prepared
// with schoolbook=True:
//
//   out[b] = acc[b] + sum_r digits_r(X^t[b] acc[b] - acc[b]) * bk[r, u]
//            in Z[X]/(X^N + 1), mod 2^32, for u in {0, 1}
//
// acc int32 [B, 2, N], t int32 [B] (rotation exponents in [0, 2N)), the
// round's key spectra complex128 [rows, 2, 2, N/2] (kernels.py::key_spectra),
// out int32 [B, 2, N] (may be acc itself).  The digits are the signed gadget
// digits of crypto/bootstrap.py::RoundOps.decompose (same offset, row =
// polynomial * l + level); they never go to memory.
//
// What it replaces: no Pallas kernel.  The JAX package runs the round as
// XLA ops around one int8 convolution (redsec_tpu/crypto/bootstrap.py:538,
// external_delta_schoolbook); the port ran it as torch rotate, difference,
// decompose and add around one launch of S1 (csrc/schoolbook.cu).  The
// output is the same exact negacyclic product, so it is bit-identical.
//
// The transform: the negacyclic twisted one.  X^N + 1 = (X^M - i)(X^M + i)
// with M = N/2, and a real polynomial a = a_lo + X^M a_hi is known from
// a mod (X^M - i) = a_lo + i a_hi.  Substituting X = zeta Y with
// zeta = exp(i pi / N) turns X^M - i into Y^M - 1, so the product is a
// cyclic convolution of length M of the twisted folds c[j] zeta^j: a
// length-M complex DFT each way, half the flops and half the key bytes of
// a zero-padded length-2N real FFT.  The key is split into sign-balanced
// 16-bit halves (bk = lo + 2^16 hi, |lo|, |hi| <= 2^15); the host prepares
// the spectra of every (round, row, u, half) once a key.  Each digit row is
// folded, twisted and transformed, and multiplied into the four
// accumulating spectra (u, half) held in registers; then each accumulated
// spectrum goes back through the inverse, is untwisted, and its real and
// imaginary parts round to the product's coefficients j and j + M.
// The two halves recombine as lo + 2^16 hi mod 2^32 and acc is added.
//
// Exactness: every value rounded is within 1/2 of its integer while the
// error bound of kernels.py::schoolbook_fft_error_bound stays below 1/2
// (Percival's Theorem 5.1 for three length-M transforms with a twist each,
// the pointwise products and the frequency-domain sum over rows, twiddles
// from kernels.py::fft_tables, computed in long double and rounded once).
// crypto/bootstrap.py::prepare_cloud_key asserts it for every key it
// prepares; it is at most 0.027 at every set of crypto/params.py.  Complex
// products here round at most 2 eps from the exact one (fma form; the bound
// takes sqrt(5) eps), and the sums are taken with explicit rounding so the
// compiler cannot reassociate them.  A radix-8 butterfly's products by W_8
// and W_8^3 are such complex products by the rounded constants, one a
// value on each path through its three levels, as the bound counts them.
//
// The DFT: Stockham passes (natural order in and out) of radix 4 first,
// radix 8 between and 2, 4 or 8 last, so that the radices multiply to M;
// twiddles W_M^m = exp(-2 pi i m / M) from one table read through the
// read-only path.  Each thread holds its M / T values in registers between
// transforms: the first pass (no twiddles) reads its butterflies' operands
// from there and the last pass writes its outputs there, so the fold and
// twist feed the forward transform, and its output the multiply-accumulate,
// without a trip through shared memory; the passes between read a buffer in
// shared memory into registers, wait at a barrier, and write it back in
// place (at N = 4096: 2 of them, at N = 8192: 3).  The inverse is
// conj(DFT(conj(x))) / M.
//
// Layout: a cluster of two blocks takes one ciphertext, one output
// polynomial each; a block has T = max(32, M / 8) threads, and each thread
// owns the spectrum bins tid + q T, q < M / T, of its polynomial's two
// accumulating spectra (2 M / T complex values in registers; the key spectra
// stream from L2 past L1 by ld.global.cg).  The pair shares the forward
// transforms: at each step each block transforms one of two digit rows,
// leaves its spectrum in an exchange buffer of its shared memory and, after
// a cluster barrier, reads its partner's through distributed shared memory
// (two exchange buffers in turn, so one barrier a step); they meet at a
// last cluster barrier after their last read of acc and of each other, so
// acc may be the output.  Shared memory: a transform buffer and the two
// exchange buffers, M complex values each (96 KB at N = 4096, two blocks an
// SM; 192 KB at N = 8192).
//
// Bound on the H100: operations, rows forward and 4 inverse transforms a
// ciphertext at the least published flop count (modified split radix,
// about 3.8 M log2 M) with their twists at 33.45e12 fp64 flops a second,
// and 32 rows M flops of MAC at DMMA's 67e12 (chip_smoke.py::
// schoolbook_round_flops, fp64_ms): 0.0202 ms at [512, 8, 4096]
// (medium_v2), where this design takes about 0.27 ms; the key spectra the
// pair reads from L2 (rows x 4 x M x 16 bytes a ciphertext, 1.05 MB a round
// at medium_v2) and the shared-memory passes are what it waits on.
//
// The extern "C" round entry returns cudaGetLastError() after its launch;
// the Python wrapper raises if it is not 0.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// A block of T = max(32, M / 8) threads; thread tid holds positions (and
// spectrum bins) tid + m T, m < PQ = M / T.  The transform's passes: radix 4
// first, radix 8 between, and a last pass of radix RL (2, 4 or 8) so that
// the radices multiply to M.
template <int M>
struct Shape {
  static constexpr int N = 2 * M;
  static constexpr int T = M / 8 > 32 ? M / 8 : 32;
  static constexpr int PQ = M / T;
  static constexpr int RL = (log2i(M) - 2) % 3 == 0 ? 8 : ((log2i(M) - 2) % 3 == 1 ? 2 : 4);
  static_assert(M >= 128 && (M & (M - 1)) == 0, "M is a power of two >= 128");
};

// a b, rounded at most 2 eps |a b| from the exact product (fma form)
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(__fma_rn(a.x, b.x, -__dmul_rn(a.y, b.y)),
                      __fma_rn(a.x, b.y, __dmul_rn(a.y, b.x)));
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(__dsub_rn(a.x, b.x), __dsub_rn(a.y, b.y));
}

// The R-point DFT (R = 2, 4 or 8; W_R = exp(-2 pi i / R)) of v, in place
// and in natural order.  Radix 8 is one radix-2 level (operand n against
// n + 4, the differences times W_8^n) and two 4-point DFTs; W_4 = -i is
// exact, W_8 and W_8^3 are complex products by the rounded constants.
template <int R>
__device__ __forceinline__ void small_dft(double2 (&v)[R]) {
  if constexpr (R == 8) {
    constexpr double c = 0.70710678118654752440;  // sqrt(1/2)
    double2 a[4], d[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      a[n] = cadd(v[n], v[n + 4]);
      d[n] = csub(v[n], v[n + 4]);
    }
    d[1] = cmul(d[1], make_double2(c, -c));
    d[2] = make_double2(d[2].y, -d[2].x);
    d[3] = cmul(d[3], make_double2(-c, -c));
    small_dft<4>(a);
    small_dft<4>(d);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = a[k];
      v[2 * k + 1] = d[k];
    }
  } else if constexpr (R == 4) {
    const double2 s0 = cadd(v[0], v[2]), d0 = csub(v[0], v[2]);
    const double2 s1 = cadd(v[1], v[3]), d1 = csub(v[1], v[3]);
    v[0] = cadd(s0, s1);
    v[1] = make_double2(__dadd_rn(d0.x, d1.y), __dsub_rn(d0.y, d1.x));  // d0 - i d1
    v[2] = csub(s0, s1);
    v[3] = make_double2(__dsub_rn(d0.x, d1.y), __dadd_rn(d0.y, d1.x));  // d0 + i d1
  } else {
    const double2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  }
}

// The first pass: radix 4, sub-transforms of one point (no twiddles).
// Butterfly j = tid + q T reads positions j + r M/4, which are x[q + 2 r]
// of its own thread (M / 4 = 2 T), and writes buf[4 j + r].  Ends with a
// barrier.
template <int M>
__device__ __forceinline__ void first_pass(const double2 (&x)[Shape<M>::PQ], double2* buf) {
  constexpr int T = Shape<M>::T, Q = M / 4 / T;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    double2 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = x[q + r * Q];
    small_dft<4>(v);
    const int j = threadIdx.x + q * T;
#pragma unroll
    for (int r = 0; r < 4; ++r) buf[4 * j + r] = v[r];
  }
  __syncthreads();
}

// One radix-8 Stockham pass over buf[0, M) with sub-transforms of Ns points
// done: butterfly j < M/8 reads buf[j + r M/8], multiplies operand r by
// W_M^(k r M/(8 Ns)) (k = j mod Ns), takes the 8-point DFT and writes
// buf[(j - k) 8 + k + r Ns].  Below M = 256 there are fewer butterflies
// than threads.  Ends with a barrier.
template <int M>
__device__ __forceinline__ void pass(double2* buf, const double2* __restrict__ tw, int Ns) {
  constexpr int T = Shape<M>::T, J = M / 8;
  const int j = threadIdx.x;
  double2 v[8];
  if (J >= T || j < J) {
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = buf[j + r * J];
  }
  __syncthreads();
  if (J >= T || j < J) {
    const int k = j & (Ns - 1);
    const int stride = M / (Ns * 8);
#pragma unroll
    for (int r = 1; r < 8; ++r) v[r] = cmul(v[r], __ldg(tw + k * r * stride));
    small_dft<8>(v);
    const int d = (j - k) * 8 + k;
#pragma unroll
    for (int r = 0; r < 8; ++r) buf[d + r * Ns] = v[r];
  }
  __syncthreads();
}

// The last pass: radix RL with Ns = M / RL (so k = j, twiddles W_M^(j r)),
// from buf into registers: butterfly j = tid + q T writes positions
// j + r M/RL, which are x[q + r Q] of its own thread (M / RL = Q T).  Ends
// with a barrier after its reads (buf is free for the next transform).
template <int M>
__device__ __forceinline__ void last_pass(double2* buf, const double2* __restrict__ tw,
                                          double2 (&x)[Shape<M>::PQ]) {
  constexpr int T = Shape<M>::T, R = Shape<M>::RL, J = M / R, Q = J / T;
  static_assert(Q >= 1 && J % T == 0, "every thread takes whole butterflies");
  double2 v[Q][R];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) v[q][r] = buf[threadIdx.x + q * T + r * J];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = threadIdx.x + q * T;
#pragma unroll
    for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], __ldg(tw + j * r));
    small_dft<R>(v[q]);
#pragma unroll
    for (int r = 0; r < R; ++r) x[q + r * Q] = v[q][r];
  }
}

// The forward DFT of the M values x holds across the block (position
// tid + m T in x[m]) into x (bin tid + m T in x[m]), natural order both
// ways.  Every thread enters; buf is scratch, free again on return.
template <int M>
__device__ __forceinline__ void dft(double2 (&x)[Shape<M>::PQ], double2* buf,
                                    const double2* __restrict__ tw) {
  first_pass<M>(x, buf);
#pragma unroll 1
  for (int Ns = 4; Ns < M / Shape<M>::RL; Ns *= 8) pass<M>(buf, tw, Ns);
  last_pass<M>(buf, tw, x);
}

// The digit of level lev at coefficient j of X^t a - a (the gadget offset
// added, as RoundOps.decompose has it); t in [0, 2N).
template <int N>
__device__ __forceinline__ double digit(const uint32_t* a, int t, int j, uint32_t offset,
                                        int shift, uint32_t mask, int half) {
  int src = j - t;
  if (src < 0) src += 2 * N;
  const bool neg = src >= N;
  if (neg) src -= N;
  const uint32_t rot = neg ? 0u - a[src] : a[src];
  const uint32_t u = rot - a[j] + offset;
  return static_cast<double>(static_cast<int>((u >> shift) & mask) - half);
}

// One CMUX round of ciphertext blockIdx.x, output polynomial u =
// blockIdx.y, by a cluster pair (blockIdx.y = its rank).  acc is not
// restrict: it may be out.
template <int M>
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(Shape<M>::T, 512 / Shape<M>::T)
    schoolbook_round_kernel(const int32_t* acc, const int32_t* __restrict__ t_all,
                            const double2* __restrict__ spec, const double2* __restrict__ tw,
                            const double2* __restrict__ twist, int32_t* out, int rows, int l,
                            int bg_bit, uint32_t offset) {
  constexpr int N = Shape<M>::N, T = Shape<M>::T, PQ = Shape<M>::PQ;
  extern __shared__ double2 buf[];  // [M] transform, then [2][M] exchange
  const int b = blockIdx.x;
  const int u = static_cast<int>(blockIdx.y);
  const int t = t_all[b];
  const uint32_t* a = reinterpret_cast<const uint32_t*>(acc) + static_cast<size_t>(b) * 2 * N;
  const int half = 1 << (bg_bit - 1);
  const uint32_t mask = (1u << bg_bit) - 1u;
  cg::cluster_group cluster = cg::this_cluster();
  double2* xch = buf + M;
  const double2* pxch = cluster.map_shared_rank(xch, 1 - u);

  double2 sum[2][PQ];  // the accumulating spectra of polynomial u, [half][bin]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < PQ; ++q) sum[h][q] = make_double2(0.0, 0.0);

  // row r's spectrum (y[q], or read through f(q)) into the accumulating
  // spectra: its (u, half) key spectra read past L1 (every block streams
  // them once a row)
  auto mac = [&](int r, auto&& y) {
    const double2* sr = spec + (static_cast<size_t>(r) * 2 + u) * 2 * M;
#pragma unroll
    for (int q = 0; q < PQ; ++q) {
      const int k = threadIdx.x + q * T;
      const double2 yq = y(q);
#pragma unroll
      for (int h = 0; h < 2; ++h) sum[h][q] = cadd(sum[h][q], cmul(yq, __ldcg(sr + h * M + k)));
    }
  };

  double2 x[PQ];
  // The pair shares its forward transforms: at step s block u transforms
  // digit row 2 s + u (folded, coefficients j and j + M as one complex
  // value, and twisted), leaves its spectrum in one of its two exchange
  // buffers (used in turn) and, after a cluster barrier, reads its
  // partner's row there.  A barrier a step suffices: a buffer is written
  // again two steps later, after the partner passed the barrier that
  // follows its reads.
#pragma unroll 1
  for (int s = 0; 2 * s < rows; ++s) {
    const int r = 2 * s + u;
    const int p = r / l, lev = r - p * l;
    const int shift = 32 - (lev + 1) * bg_bit;
    const uint32_t* ap = a + p * N;
#pragma unroll
    for (int q = 0; q < PQ; ++q) {
      const int j = threadIdx.x + q * T;
      const double2 c = make_double2(digit<N>(ap, t, j, offset, shift, mask, half),
                                     digit<N>(ap, t, j + M, offset, shift, mask, half));
      x[q] = cmul(c, __ldg(twist + j));
    }
    dft<M>(x, buf, tw);
    double2* own = xch + (s & 1) * M;
#pragma unroll
    for (int q = 0; q < PQ; ++q) own[threadIdx.x + q * T] = x[q];
    cluster.sync();
    mac(r, [&](int q) { return x[q]; });
    const double2* other = pxch + (s & 1) * M;
    mac(2 * s + 1 - u, [&](int q) { return other[threadIdx.x + q * T]; });
  }
  cluster.sync();  // the pair's last read of acc[b] and of each other's memory

  const double inv_m = 1.0 / M;
  uint32_t res[2][PQ];
#pragma unroll
  for (int q = 0; q < PQ; ++q) res[0][q] = res[1][q] = 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < PQ; ++q) x[q] = make_double2(sum[h][q].x, -sum[h][q].y);
    dft<M>(x, buf, tw);
#pragma unroll
    for (int q = 0; q < PQ; ++q) {
      const double2 w = __ldg(twist + threadIdx.x + q * T);
      // conj(x) / M (the inverse), times conj(zeta^j) (the untwist)
      const double2 v = cmul(make_double2(x[q].x * inv_m, -x[q].y * inv_m),
                             make_double2(w.x, -w.y));
      res[0][q] += static_cast<uint32_t>(__double2ll_rn(v.x)) << (16 * h);
      res[1][q] += static_cast<uint32_t>(__double2ll_rn(v.y)) << (16 * h);
    }
  }
  const size_t base = (static_cast<size_t>(b) * 2 + u) * N;
#pragma unroll
  for (int q = 0; q < PQ; ++q) {
    const int j = threadIdx.x + q * T;
    out[base + j] = static_cast<int32_t>(static_cast<uint32_t>(acc[base + j]) + res[0][q]);
    out[base + j + M] = static_cast<int32_t>(static_cast<uint32_t>(acc[base + j + M]) + res[1][q]);
  }
}

struct RoundArgs {
  const int32_t* acc;
  const int32_t* t;
  const double2* spec;
  const double2* tw;
  const double2* twist;
  int32_t* out;
  int B, rows, l, bg_bit;
  uint32_t offset;
};

template <int M>
cudaError_t launch(const RoundArgs& a, cudaStream_t stream) {
  const int smem = 3 * M * static_cast<int>(sizeof(double2));
  cudaError_t e = cudaFuncSetAttribute(schoolbook_round_kernel<M>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  schoolbook_round_kernel<M><<<dim3(a.B, 2), Shape<M>::T, smem, stream>>>(
      a.acc, a.t, a.spec, a.tw, a.twist, a.out, a.rows, a.l, a.bg_bit, a.offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* redsec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[B, 2, N] = acc + the round's external product (see the top); spec is
// the round's spectra [rows][2][2][N/2] complex128, tw the table W_M^m and
// twist zeta^j (both [N/2] complex128).
int redsec_schoolbook_round(const int32_t* acc, const int32_t* t, const void* spec,
                            const void* tw, const void* twist, int32_t* out, int B, int N,
                            int rows, int l, int bg_bit, uint32_t offset, cudaStream_t stream) {
  if (B <= 0 || l <= 0 || bg_bit <= 0 || l * bg_bit > 32 || rows != 2 * l)
    return static_cast<int>(cudaErrorInvalidValue);
  const RoundArgs a{acc, t, static_cast<const double2*>(spec), static_cast<const double2*>(tw),
                    static_cast<const double2*>(twist), out, B, rows, l, bg_bit, offset};
  switch (N) {
    case 256: return static_cast<int>(launch<128>(a, stream));
    case 512: return static_cast<int>(launch<256>(a, stream));
    case 1024: return static_cast<int>(launch<512>(a, stream));
    case 2048: return static_cast<int>(launch<1024>(a, stream));
    case 4096: return static_cast<int>(launch<2048>(a, stream));
    case 8192: return static_cast<int>(launch<4096>(a, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
