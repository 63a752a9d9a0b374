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
// accumulating spectra (u, half); then each accumulated spectrum goes back
// through the inverse, is untwisted, and its real and imaginary parts round
// to the product's coefficients j and j + M.
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
// twiddles W_M^m = exp(-2 pi i m / M) from one table, laid out in the order
// the passes read them (kernels.py::fft_pass_index: M - 4 entries), read
// through the read-only path.  Each thread holds its M / T values in registers between
// transforms: the first pass (no twiddles) reads its butterflies' operands
// from there and the last pass writes its outputs there, so the fold and
// twist feed the forward transform, and the gathered spectrum the inverse,
// without a trip through a buffer of their own; the passes between read the
// block's buffer in shared memory into registers, wait at a barrier, and
// write it back in place (at N = 4096: 2 of them, at N = 8192:
// 3).  The inverse is conj(DFT(conj(x))) / M.  The MAC sums the rows in
// order, r = 0 first, each product rounded once and added with one
// rounding, as the bound counts them whichever block computes a bin.
//
// Layout: four blocks work for each ciphertext, and a cluster takes two
// ciphertexts (eight blocks) at N >= 512, one (four blocks) at N = 256; a
// block has T = max(32, M / 8) threads, thread tid holding positions (and
// bins) tid + q T, q < M / T, of the transform it runs.  The digit rows
// come in chunks of 4 kSlots = 8 (one chunk at every set of
// crypto/params.py but the forced N <= 2048 ones): the block in role c % 4
// takes rows c % 4 and c % 4 + 4 of its ciphertext's chunk, folds them from
// acc[b] staged in its shared memory, transforms each and sends each slice
// of bins of the spectrum to the inbox of the block that owns those bins
// (distributed shared memory stores, which do not wait).  For the MAC each
// block owns 1 / C of the bins of both ciphertexts: it reads that slice of
// each key spectrum (u, half) once for the cluster (streamed from L2 past
// L1 by ld.global.cg: each key value is read once for two ciphertexts) and
// the rows' slices from its inbox; the sums live in registers through the
// MAC only, and go to the buffer of the block that inverts them.  Each
// block inverts and rounds one accumulated spectrum (u, half) of its
// ciphertext; the two blocks of polynomial u swap halves of their rounded
// values (uint32), and each adds acc to and stores half of its
// coefficients.  Each block runs 3 transforms a round at rows = 8 (2
// forward, 1 inverse), so a batch of B spreads over 4 B blocks, and no
// spectrum stays in registers across a transform.  Three cluster barriers
// a round of one chunk (after the forward transforms, the MAC and the
// swap): every read of acc[b] precedes the first but a block's read of the
// half it stores, so acc may be the output.  Shared memory: a transform
// buffer of pad(M) complex values and an inbox of 2 M (100 KB at N = 4096,
// two blocks an SM; 200 KB at N = 8192).
//
// Bound on the H100: operations, rows forward and 4 inverse transforms a
// ciphertext at the least published flop count (modified split radix,
// about 3.8 M log2 M) with their twists at 33.45e12 fp64 flops a second,
// and 32 rows M flops of MAC at DMMA's 67e12 (chip_smoke.py::
// schoolbook_round_flops, fp64_ms): 0.0202 ms at [512, 8, 4096]
// (medium_v2).  The clusters read the key spectra from L2 (rows x 4 x M x
// 16 bytes for every two ciphertexts, 0.52 MB a ciphertext at medium_v2);
// the transforms' shared-memory passes, the key stream and the barriers are
// what it waits on (PERF.md, tools/sbfft_spans.py).
//
// The extern "C" round entry returns cudaGetLastError() after its launch;
// the Python wrapper raises if it is not 0.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// Where position i of a transform lies in its buffer: one padding entry
// after every 8, so that the first pass's stores (4 j + r) and a radix-8
// pass's at Ns = 4 hit 8 different 16-byte bank groups in every quarter
// warp, and consecutive positions stay conflict-free.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 3); }

constexpr int kR = 4;      // blocks a ciphertext: one accumulated spectrum (u, half) each
constexpr int kSlots = 2;  // digit rows a block transforms in a chunk

// A block of T = max(32, M / 8) threads; thread tid holds positions (and
// spectrum bins) tid + m T, m < PQ = M / T.  The transform's passes: radix 4
// first, radix 8 between, and a last pass of radix RL (2, 4 or 8) so that
// the radices multiply to M.  A cluster takes CT ciphertexts (2 at N >=
// 512, 1 at N = 256), C = 4 CT blocks, and a block owns M / C = T bins in
// the MAC, one a thread, of every ciphertext of the cluster: bin
// tid + q T of a transform is block q's (PQ = C).  A transform's buffer
// takes MP = pad(M) entries.
template <int M>
struct Shape {
  static constexpr int N = 2 * M;
  static constexpr int T = M / 8 > 32 ? M / 8 : 32;
  static constexpr int PQ = M / T;
  static constexpr int RL = (log2i(M) - 2) % 3 == 0 ? 8 : ((log2i(M) - 2) % 3 == 1 ? 2 : 4);
  static constexpr int CT = M >= 256 ? 2 : 1;
  static constexpr int C = kR * CT;
  static constexpr int MP = pad(M);
  static_assert(PQ == C, "a block owns M / C = T bins, one a thread");
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
// of its own thread (M / 4 = 2 T), and writes position 4 j + r.  Ends with a
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
    for (int r = 0; r < 4; ++r) buf[pad(4 * j + r)] = v[r];
  }
  __syncthreads();
}

// One radix-8 Stockham pass over buf[0, M) with sub-transforms of Ns points
// done: butterfly j < M/8 reads buf[j + r M/8], multiplies operand r by
// W_M^(k r M/(8 Ns)) (k = j mod Ns; the table holds them pass by pass,
// kernels.py::fft_pass_index, so a warp reads consecutive twiddles and not
// one line a thread), takes the 8-point DFT and writes
// buf[(j - k) 8 + k + r Ns].  Below M = 256 there are fewer butterflies
// than threads.  Ends with a barrier.
template <int M>
__device__ __forceinline__ void pass(double2* buf, const double2* __restrict__ tw, int Ns) {
  constexpr int T = Shape<M>::T, J = M / 8;
  const int j = threadIdx.x;
  double2 v[8];
  if (J >= T || j < J) {
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = buf[pad(j + r * J)];
  }
  __syncthreads();
  if (J >= T || j < J) {
    const int k = j & (Ns - 1);
    const double2* twp = tw + (Ns - 4) + k;  // W_M^(k r M / (8 Ns)) at (r - 1) Ns
#pragma unroll
    for (int r = 1; r < 8; ++r) v[r] = cmul(v[r], __ldg(twp + (r - 1) * Ns));
    small_dft<8>(v);
    const int d = (j - k) * 8 + k;
#pragma unroll
    for (int r = 0; r < 8; ++r) buf[pad(d + r * Ns)] = v[r];
  }
  __syncthreads();
}

// The last pass: radix RL with Ns = M / RL (so k = j, twiddles W_M^(j r),
// at J - 4 + (r - 1) J + j in the table), from buf into registers: butterfly j = tid + q T writes positions
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
    for (int r = 0; r < R; ++r) v[q][r] = buf[pad(threadIdx.x + q * T + r * J)];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = threadIdx.x + q * T;
#pragma unroll
    for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], __ldg(tw + (J - 4) + (r - 1) * J + j));
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

// The two halves of cluster.sync(), so that a block can issue loads that do
// not depend on its partners while it waits for them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// One CMUX round of the CT ciphertexts b0 + e (b0 = CT blockIdx.x / C) by
// a cluster of C blocks; block c = its rank in the cluster works for
// ciphertext e = c / 4 in role c % 4.  acc is not restrict: it may be out.
// MULTI: more than one chunk of rows (rows > 4 kSlots, forced N <= 2048
// sets), the MAC's sums carried in registers from chunk to chunk (one block
// an SM, so that they need not spill below N = 8192).
//
// 1. Forward: the digit rows come in chunks of 4 kSlots rows.  The block
//    in role c % 4 takes rows c % 4 and c % 4 + 4 of its ciphertext's chunk:
//    folds and twists them (from acc[b] staged in its buffer, in the first
//    chunk), transforms each in its buffer and sends each slice of the
//    spectrum to the inbox of the block that owns those bins (distributed
//    shared memory stores).  The cluster meets.
// 2. MAC: block c owns the bins [c T, (c + 1) T) of every ciphertext of
//    the cluster.  For each row of the chunk, in order, it reads that slice
//    of the 4 key spectra (u, half) once, and each ciphertext's row slice
//    from its inbox, and accumulates the products in registers.  After the
//    last chunk it sends the sums of spectrum (ciphertext ee, (u, half) v)
//    to the buffer of block 4 ee + v.  The cluster meets.
// 3. Inverse: block c transforms its buffer, the accumulated spectrum (u,
//    half) = (c % 4 / 2, c % 2) of its ciphertext, untwists and rounds.
//    The two blocks of polynomial u swap halves of their rounded values, as
//    uint32, through each other's inboxes; the cluster meets; each
//    recombines lo + 2^16 hi for its half of the coefficients, adds acc and
//    stores.
// A ciphertext past B (the last cluster of an odd batch at CT = 2) has its
// blocks meet the cluster's barriers and run their MAC for the other one.
template <int M, bool MULTI>
__global__ void __cluster_dims__(Shape<M>::C, 1, 1)
    __launch_bounds__(Shape<M>::T, MULTI ? 1 : 512 / Shape<M>::T)
    schoolbook_round_kernel(const int32_t* acc, const int32_t* __restrict__ t_all,
                            const double2* __restrict__ spec, const double2* __restrict__ tw,
                            const double2* __restrict__ twist, int32_t* out, int B, int rows,
                            int l, int bg_bit, uint32_t offset) {
  constexpr int N = Shape<M>::N, T = Shape<M>::T, PQ = Shape<M>::PQ, CT = Shape<M>::CT,
                MP = Shape<M>::MP;
  constexpr int RC = kR * kSlots;  // rows a chunk
  // buf: [MP] a transform's buffer (padded); it holds acc[b] (int32 [2][N])
  // while the first chunk's digits are taken, and receives the accumulated
  // spectrum the block inverts.  inbox: [CT][RC][T] the chunk's row
  // spectra at the block's bins; at the end the swapped halves.
  extern __shared__ double2 smem[];
  double2* const buf = smem;
  double2* const inbox = smem + MP;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int e = c / kR, role = c % kR;
  const int b0 = static_cast<int>(blockIdx.x) / Shape<M>::C * CT;
  const int b = b0 + e;
  const int nct = min(CT, B - b0);  // the cluster's ciphertexts
  const bool live = e < nct;
  // --- phase: setup ---
  const int t = live ? t_all[b] : 0;
  const uint32_t* a = reinterpret_cast<const uint32_t*>(acc) + static_cast<size_t>(b) * 2 * N;
  const int half = 1 << (bg_bit - 1);
  const uint32_t mask = (1u << bg_bit) - 1u;
  // the pair (u, lo) and (u, hi), blocks c and c ^ 1, swap halves in the
  // end: block c stores coefficients [h M, (h + 1) M) of polynomial u
  const int u = role >> 1, h = role & 1;
  const size_t base = (static_cast<size_t>(b) * 2 + u) * N + h * M;
  uint32_t mine[PQ];  // acc's half that this block stores
  double2 x[PQ];
  double2 sv[CT][4];  // sums (ciphertext ee, (u, half) v) of bin c T + tid
#pragma unroll
  for (int ee = 0; ee < CT; ++ee)
#pragma unroll
    for (int v = 0; v < 4; ++v) sv[ee][v] = make_double2(0.0, 0.0);

#pragma unroll 1
  for (int r0 = 0; r0 < (MULTI ? rows : 1); r0 += RC) {
    const int nr = min(RC, rows - r0);
    // --- phase: forward ---
    const int ns = nr > role ? min(kSlots, (nr - role + kR - 1) / kR) : 0;  // the block's rows
    if (live && ns > 0) {
      double2 x1[PQ];  // the second row's fold, while the first is transformed
      // the fold and twist of the block's rows of the chunk, from the
      // polynomials at src (int32 [2][N])
      auto fold = [&](const uint32_t* src) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (s < ns) {
            const int r = r0 + role + kR * s;
            const int p = r / l, lev = r - p * l;
            const int shift = 32 - (lev + 1) * bg_bit;
            const uint32_t* ap = src + p * N;
#pragma unroll
            for (int q = 0; q < PQ; ++q) {
              const int j = threadIdx.x + q * T;
              const double2 d = make_double2(digit<N>(ap, t, j, offset, shift, mask, half),
                                             digit<N>(ap, t, j + M, offset, shift, mask, half));
              const double2 z = cmul(d, __ldg(twist + j));
              if (s == 0)
                x[q] = z;
              else
                x1[q] = z;
            }
          }
        }
      };
      // the first chunk takes its digits from acc[b] staged in buf by
      // 16-byte loads; a later one from memory
      if (r0 == 0) {
        uint4* stage = reinterpret_cast<uint4*>(buf);
#pragma unroll
        for (int q = 0; q < PQ; ++q)
          stage[threadIdx.x + q * T] = reinterpret_cast<const uint4*>(a)[threadIdx.x + q * T];
        __syncthreads();
        fold(reinterpret_cast<const uint32_t*>(buf));
      } else {
        fold(a);
      }
      if (r0 == 0) __syncthreads();  // the stage read: buf takes the transforms
#pragma unroll 1
      for (int s = 0; s < ns; ++s) {
        if (s > 0) {
#pragma unroll
          for (int q = 0; q < PQ; ++q) x[q] = x1[q];
        }
        dft<M>(x, buf, tw);
        // bin tid + q T to the inbox of block q (row role + 4 s of ciphertext e)
        double2* dst = inbox + (e * RC + role + kR * s) * T + threadIdx.x;
#pragma unroll
        for (int q = 0; q < PQ; ++q) *(q == c ? dst : cluster.map_shared_rank(dst, q)) = x[q];
      }
    }
    // --- phase: rows stored ---
    cluster_arrive();
    // row rr's key values (u, half) v at the thread's bin; the first row's
    // are fetched while the cluster meets, each next one while a row is summed
    auto fetch = [&](int rr, double2(&k_)[4]) {
      const double2* kr = spec + static_cast<size_t>(r0 + rr) * 4 * M + c * T + threadIdx.x;
#pragma unroll
      for (int v = 0; v < 4; ++v) k_[v] = __ldcg(kr + v * M);
    };
    double2 kv[4];
    fetch(0, kv);
    cluster_wait();
    // --- phase: mac ---
#pragma unroll 1
    for (int rr = 0; rr < nr; ++rr) {
      double2 kn[4];
      if (rr + 1 < nr) fetch(rr + 1, kn);
#pragma unroll
      for (int ee = 0; ee < CT; ++ee) {
        if (ee < nct) {
          const double2 y = inbox[(ee * RC + rr) * T + threadIdx.x];
#pragma unroll
          for (int v = 0; v < 4; ++v) sv[ee][v] = cadd(sv[ee][v], cmul(y, kv[v]));
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) kv[v] = kn[v];
    }
    if (r0 + RC >= rows) {  // the last chunk: the sums to the blocks that invert them
#pragma unroll
      for (int ee = 0; ee < CT; ++ee)
        if (ee < nct)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            *cluster.map_shared_rank(buf + pad(c * T + threadIdx.x), ee * kR + v) = sv[ee][v];
    }
    // --- phase: mac done ---
    cluster_arrive();
    if (live && r0 + RC >= rows) {  // acc's half that this block stores, while the cluster meets
#pragma unroll
      for (int q = 0; q < PQ; ++q) mine[q] = static_cast<uint32_t>(acc[base + threadIdx.x + q * T]);
    }
    cluster_wait();
    // --- phase: chunk done ---
  }

  // --- phase: inverse ---
  // each block of the pair hands its partner the rounded values of the
  // half it does not store
  uint32_t keep[PQ];  // the rounded values of the half this block stores
  if (live) {
#pragma unroll
    for (int q = 0; q < PQ; ++q) {
      const double2 v = buf[pad(threadIdx.x + q * T)];
      x[q] = make_double2(v.x, -v.y);
    }
    __syncthreads();  // every thread's spectrum read before the first pass writes buf
    dft<M>(x, buf, tw);
    const double inv_m = 1.0 / M;
    uint32_t* dst = cluster.map_shared_rank(reinterpret_cast<uint32_t*>(inbox), c ^ 1);
#pragma unroll
    for (int q = 0; q < PQ; ++q) {
      const double2 w = __ldg(twist + threadIdx.x + q * T);
      // conj(x) / M (the inverse), times conj(zeta^j) (the untwist)
      const double2 v = cmul(make_double2(x[q].x * inv_m, -x[q].y * inv_m),
                             make_double2(w.x, -w.y));
      const uint32_t re = static_cast<uint32_t>(__double2ll_rn(v.x));  // coefficient j
      const uint32_t im = static_cast<uint32_t>(__double2ll_rn(v.y));  // coefficient j + M
      keep[q] = h ? im : re;
      dst[threadIdx.x + q * T] = h ? re : im;
    }
  }
  // --- phase: handed over ---
  cluster.sync();
  // --- phase: store ---
  if (live) {
    const uint32_t* got = reinterpret_cast<const uint32_t*>(inbox);
#pragma unroll
    for (int q = 0; q < PQ; ++q) {
      const int j = threadIdx.x + q * T;
      const uint32_t lo = h ? got[j] : keep[q], hi = h ? keep[q] : got[j];
      out[base + j] = static_cast<int32_t>(mine[q] + lo + (hi << 16));
    }
  }
  // --- phase: end ---
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

template <int M, bool MULTI>
cudaError_t launch_as(const RoundArgs& a, cudaStream_t stream) {
  const int smem = (Shape<M>::MP + 2 * M) * static_cast<int>(sizeof(double2));
  constexpr int C = Shape<M>::C, CT = Shape<M>::CT;
  cudaError_t e = cudaFuncSetAttribute(schoolbook_round_kernel<M, MULTI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  schoolbook_round_kernel<M, MULTI><<<dim3(C * ((a.B + CT - 1) / CT)), Shape<M>::T, smem,
                                      stream>>>(a.acc, a.t, a.spec, a.tw, a.twist, a.out, a.B,
                                                a.rows, a.l, a.bg_bit, a.offset);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch(const RoundArgs& a, cudaStream_t stream) {
  return a.rows > kR * kSlots ? launch_as<M, true>(a, stream) : launch_as<M, false>(a, stream);
}

}  // namespace

extern "C" {

const char* redsec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[B, 2, N] = acc + the round's external product (see the top); spec is
// the round's spectra [rows][2][2][N/2] complex128, tw the table W_M^m in
// the passes' order ([N/2 - 4], kernels.py::fft_tables) and twist zeta^j
// ([N/2]), complex128.
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
