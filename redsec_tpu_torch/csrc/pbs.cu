// Blind-rotation kernels for Hopper (sm_90a): the programmable bootstrap's hot
// loop, a Python module of C entries (py_entries.cuh) under
// redsec_tpu_torch/crypto/kernels.py.
//
// Four thin __global__ entries over one set of device functions; each
// replaces a Pallas TPU kernel of the JAX package and computes the same
// function (outputs bit-identical), not the same blocks:
//
//   ntt_kernel            <- redsec_tpu/crypto/pallas_ntt.py::ntt_pallas
//   external_product      <- redsec_tpu/crypto/pallas_round.py::make_round_kernel
//   cmux_round            <- redsec_tpu/crypto/pallas_round.py::make_full_round_kernel
//   blind_rotate          <- redsec_tpu/crypto/pallas_blind.py::make_blind_rotate_kernel
//
// The TPU kernels' 128-point four-step DFTs exist for the MXU; on CUDA cores a
// radix-2 butterfly NTT needs ~25x fewer modular products, so the BK is
// prepared in the radix-2 bit-reversed order of ntt.ntt_device (flavour
// "radix2") and the same butterflies run here.  The PBS output is the exact
// negacyclic product mod 2^32 whatever the transform, so outputs match the
// JAX package bit for bit.  Torus arithmetic is uint32 (signed overflow is
// undefined in C++).
//
// Design.  A block has N/2 threads (N/4 at N = 2048) and owns G ciphertexts
// (G = 2 when the batch exceeds the card's SM count and two fit shared
// memory at some chunk of digit rows, else 1; a ragged last block computes
// on a zero accumulator and stores nothing for the missing ciphertext).
// Every NTT-plan branch of the JAX package has an instance: N = 256 .. 2048,
// two or three primes below 2^16, plain rounds and 2-bit bundled ones at
// every N (blind_rotate_kernel<N, G, P, D>, D = 1 or 3 differences a round).
//
// * Transforms run in registers.  N/16 threads share one polynomial, 16
//   coefficients a thread, so a block transforms 8 polynomials at once (4 at
//   N = 2048: 8 would need 1,024 threads and twice an SM's registers).  A
//   transform is three register passes of 4 + 4 + log2(N/256) radix-2
//   stages with two exchanges through shared memory between them (the last
//   pass on runs of four coefficients, of eight at N = 2048): two
//   __syncthreads() a batch of transforms (the first version had one
//   barrier a stage).  The exchange buffers are padded by N/256 words every
//   N/16 so that the three access patterns avoid bank conflicts, and there
//   are two per polynomial (first and second exchange) so that no barrier is
//   needed between reading one and writing the next.
// * Lazy arithmetic, p < 2^16.  Every twiddle w comes with w' = floor(w *
//   2^32 / p) (Shoup): x * w mod p = x*w - umulhi(x, w')*p lies in [0, 2p)
//   for ANY uint32 x.  Forward (decimation in frequency): the sum x + y is
//   not reduced, so a value entering stage s is below B0 * 2^s, where B0
//   bounds the twisted input; the difference x - y + B0 * 2^s is
//   non-negative and goes through the Shoup product; one Barrett reduction
//   to [0, p) ends the transform (2p * 2048 = 1.7e8 at 40961).  The twist is a
//   Shoup product (B0 = 2p) or, for gadget digits in [-Bg/2, Bg/2) with
//   Bg * p * N < 2^32 for every prime, the single multiply-add
//   d * psi^k + (Bg/2) * p (B0 = Bg * p; 6.7e8 at small_v2_n2048; small's
//   Bg = 2^10 takes the Shoup twist).  Inverse (decimation in time):
//   t = y * w in [0, 2p), outputs x + t and x - t + 2p grow by 2p a stage (the
//   first log2(N/256) stages, whose first butterfly skips its product,
//   double instead; below 32p at N = 2048); the untwist's Shoup product and
//   one conditional subtraction end it in [0, p).  The MAC adds products of
//   residues without reducing as long as they fit a uint32 beside a carried
//   value below 2p: 28 at 12289, 12 at 18433, 2 at 40961, so it reduces
//   before the product that would not fit.  The sums are stored in 16 bits:
//   below 2p, or below p for a prime above 2^15.
//   tests/test_torch_kernel_arith.py models exactly this arithmetic in numpy
//   and checks every bound.
// * CRT.  Garner's digits stay below their primes.  Two primes: the value
//   fits 30 bits and its sign is 2v >= p0 p1.  Three: the value is below
//   P = 9.3e12 and its sign is decided exactly in 64 bits against P/2; the
//   external product stays below P/2 (ntt.primes_for), so this agrees with
//   the JAX package's fp32 estimate on every reachable value.
// * Twiddles.  The stage tables of every prime and both directions (uint2 =
//   (w, w'), 16 KB a prime at N = 1024) are staged in shared memory once a
//   block; where they do not fit beside the rest (N = 2048, and two
//   ciphertexts a block at three primes or in a bundled round at N = 1024)
//   the region holds one prime's at a time (32 or 16 KB): the launch stages
//   prime 0's forward table once, and each half is then refilled with the
//   next prime's by cp.async as soon as what it holds is dead, in a commit
//   group of the key ring, so the ring's own waits and barriers cover the
//   copies: the inverse half as a prime starts (the last prime's inverse
//   transforms ended at the barrier before), the forward half with the
//   first key row issued after the barrier that ends the prime's last
//   forward transforms (pass C still reads it before that barrier; the next
//   round's first prime after the last).  No block waits for a table.
//   Twist and untwist (one coalesced load a coefficient) come through the
//   read-only cache.  Table layout per prime, uint2 [4][N]: twist, forward
//   stage tables (the stage of half-span h at offset N - 2h), untwist
//   (psi^-j / N), inverse stage tables (half-span h at offset h - 1); values
//   and order of ntt.NttPlan (kernels.shoup_tables builds it).
// * One key load serves G ciphertexts, and its latency stays out of the
//   loop.  The exchange buffers, idle in the MAC, hold a ring of four BK
//   rows (two at N = 2048).  Each thread copies eight consecutive
//   coefficients of E = N/T of the eight limb polynomials of a row, E runs
//   of 16 bytes, ahead of the row it multiplies, each by one cp.async.cg,
//   which keeps the rows out of L1, where the transforms read their twists
//   (the same 16-byte copies through L1, cp.async.ca, were 9-11% slower at
//   N = 2048, and .cg takes no smaller size; PERF.md); no block barrier.  At
//   one ciphertext a block it multiplies just those runs (digits and sums
//   likewise 16 bytes a load); at two it multiplies its E coefficients of
//   all eight limb polynomials, words its warp's lanes copied (a __syncwarp
//   after the wait and before the slot's refill), so that each digit it
//   loads serves eight products and each residue two: the runs' layout,
//   with a ciphertext's eight digits a row a thread, was 0.6-3.9% slower
//   there, and the warp's (timed without the early rows) 3-4% slower at one
//   a block (PERF.md).  Residues are
//   zero-extended 16-bit patterns (40961 is one of the int16 BK).  The
//   slots lie on the halves of the exchange buffers (Geo::slot), the first
//   POLYS / 4 of them on the x0 halves, which pass C of a transform does not
//   read: a chunk's first one or two rows are issued right after the second
//   barrier of its last forward batch, and fly during pass C and the barrier
//   after it, instead of after them.
// * Digit rows in chunks.  Where all rows' transforms do not fit shared
//   memory beside the rest (20 rows at N = 2048 or of two ciphertexts, a
//   bundled round's 30 rows at three primes, 36 of two ciphertexts or 60 at
//   N = 2048), the
//   rows are transformed and multiplied `cr` at a time (G * cr a multiple of
//   the polynomials a block transforms: the largest such chunk that fits);
//   the MAC's sums stay in registers across chunks.
// * blind_rotate loops over all rounds inside the block (the TPU's
//   sequential grid axis has no Hopper counterpart): the accumulators stay in
//   shared memory (where nothing else fits, on r2, below); each round
//   writes X^t acc - acc + gadget offset once into shared memory, and the
//   forward transforms cut their digits out of it.
//   A bundled round (the JAX package's bundle == 2 body) writes three
//   differences: u = X^ti acc - acc, v = X^tj acc - acc and w = X^tj u - u,
//   the last as X^(ti+tj) acc - X^ti acc - X^tj acc + acc, all from acc in
//   one pass; digit row = which * 2l + bloc * l + level against the round's
//   interleaved key [bk(s_2i) | bk(s_2i+1) | bk(s_2i * s_2i+1)].
//
// Shared memory (dynamic, opted in with cudaFuncSetAttribute; a block may
// have 232,448 B), stage tables / exchange / accumulators and differences /
// digit rows and the last prime's MAC sums (uint16) / the other primes' MAC
// sums, beyond one wave of blocks (kernels.k4_layout mirrors the rule):
//   small_v2_tpu, N 1024, 12 rows, G 2:   32 + 68 + 32 + 48 + 32 KB = 217,088 B
//   small_v2, 20 rows in chunks of 12, G 2:
//                                          32 + 68 + 32 + 48 + 32 KB = 217,088 B
//   small, three primes, 6 rows, G 2, one prime's tables refilled:
//                                          16 + 68 + 32 + 32 + 64 KB = 217,088 B
//   bundled small_v2_tpu, 36 rows in chunks of 8, G 2, one prime's tables refilled:
//                                          16 + 68 + 64 + 32 + 32 KB = 217,088 B
//   bundled small_v2_tpu2, 30 rows in chunks of 4, three primes, G 2, one
//   prime's tables refilled, the three differences only (the accumulators on
//   r2), the chunk's digit rows only (the last prime's sums on the differences):
//                                          16 + 68 + 48 + 16 + 64 KB = 217,088 B
//   small_v2_n2048, N 2048, chunks of 12, G 1, one prime's tables refilled:
//                                          32 + 68 + 32 + 48 + 32 KB = 217,088 B
//   bundled small_v2_n2048, 60 rows in chunks of 8, G 1, one prime's tables
//   refilled, the three differences only (the accumulators on r2):
//                                          32 + 68 + 48 + 32 + 32 KB = 217,088 B
// Within a prime the words change hands as follows: a one-prime table
// region's forward half is read by the forward transforms and refilled
// during the last chunk's MAC, its inverse half read by the inverse
// transforms and refilled from the next prime's start; the exchange buffers
// are the transforms' x0/x1 and the ring's slots (those on x0 from the last
// forward batch's pass C, the others after the barrier that ends it, all
// free again at the chunk's last barrier); r1 holds the chunk's digit rows,
// then the last prime's MAC sums; r2 the other primes' sums, each inverted
// in place (where it holds them, the accumulators between rounds).
// The layout is the first of the following that fits at the smallest
// chunk (Smem): every prime's tables; one prime's, refilled; the
// accumulators on r2 as well, each thread carrying the words it adds to in
// registers from before the differences are written until after the CRT has
// read r2 (Smem::ALIAS: a bundled round at N = 2048, 233,472 B with them in
// their own words, 1,024 over what a block may have); the last prime's MAC
// sums on the round's differences as well, dead once that prime's last
// forward transforms have cut their digits, so that r1 holds only the
// chunk's rows (Smem::ON_DIFF: bundled small_v2_tpu2 at two a block,
// 233,472 B with r1 holding the sums).  At N = 2048 two ciphertexts do not
// fit (266,240 and 282,624 B at the smallest chunk); a cluster of two
// blocks, one ciphertext each, that loaded each key row once for both by a
// multicast bulk copy was slower than one a block on the H100 (PERF.md),
// so they run one a block.  Up to one wave of blocks every set runs one a
// block (small_v2 176,128 B with all 20 rows, small 184,320, bundled
// small_v2_tpu 225,280, bundled small_v2_tpu2 217,088 in chunks of 16).
// One block of 16 warps per SM (124-128 registers a thread).
//
// Bound on this card: int32 instructions in the transforms, and in the MAC
// the rate at which the ring brings key rows from L2 into shared memory.
// The prepared BK is 137.6 MB at small_v2_tpu, 41 us at 3.35 TB/s, while 512
// ciphertexts' rounds are ~2e11 modular operations (chip_smoke.py counts
// both); each operation is several instructions.  But every block reads
// every key row of every round from L2, and the ring moves them at 5.4e12
// B/s with 4-byte copies (8.5e12 with 8-byte ones at N = 2048;
// tools/l2_rate.py), which is why a key row loaded once for two ciphertexts
// pays.  With the rows copied past L1 in 16-byte runs the MAC runs near its
// own instruction floor at N = 2048 (tools/k4_spans.py times each phase of
// a block), and the transforms, bound by int32 issue, take most of the
// time at every N.  PERF.md has
// the instruction count read from the SASS (scripts/sass_count.py), the
// floor it gives at 64 int32 lanes an SM, and the measured times.
//
// Each extern "C" entry returns cudaGetLastError() after its launch; the
// Python wrapper raises if it is not 0.  A kernel's shared-memory opt-in and
// the SM count are asked once per instance and device (launch_once.cuh).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "launch_once.cuh"
#include "py_entries.cuh"

namespace {

constexpr int kPer = 16;          // coefficients a thread holds in a transform
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

struct Mod {
  uint32_t p;
  uint32_t m;  // floor(2^32 / p)
};

__host__ __device__ __forceinline__ Mod make_mod(uint32_t p) {
  Mod r;
  r.p = p;
  r.m = static_cast<uint32_t>(0x100000000ull / p);
  return r;
}

// x mod p in [0, 2p) for any uint32 x: the umulhi quotient is floor(x/p) or
// one less.
__device__ __forceinline__ uint32_t reduce_2p(uint32_t x, Mod md) {
  return x - __umulhi(x, md.m) * md.p;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t p) {
  return x >= p ? x - p : x;
}

// x mod p in [0, p) for any uint32 x.
__device__ __forceinline__ uint32_t reduce(uint32_t x, Mod md) {
  return csub(reduce_2p(x, md), md.p);
}

// x * w mod p in [0, 2p) for any uint32 x; tw = (w, floor(w * 2^32 / p)).
// q is floor(x*w/p) or one less, and the difference is taken mod 2^32.
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint2 tw, uint32_t p) {
  return x * tw.x - __umulhi(x, tw.y) * p;
}

// Asynchronous 4-, 8- or 16-byte copy from global to shared memory (LDGSTS):
// the data goes past the registers, and the thread waits for it only where
// it needs it.  smem_addr is an address in the shared window (shared_address).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t smem_addr, const void* gmem) {
  if constexpr (BYTES == 16)  // cached in L2 only: key rows and tables pass L1 by
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr), "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr), "l"(gmem),
                 "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ uint32_t shared_address(const void* smem) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(smem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most K of this thread's committed groups are still in flight.
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}
// The same for K = min(k, R - 1), k >= 0 (uniform over the block).
template <int R>
__device__ __forceinline__ void cp_async_wait_upto(int k) {
  if constexpr (R > 1) {
    if (k >= R - 1)
      cp_async_wait<R - 1>();
    else
      cp_async_wait_upto<R - 1>(k);
  } else {
    cp_async_wait<0>();
  }
}

// Geometry of one transform and of a block: L threads a polynomial, thread t
// of them holds 16 coefficients.  Pass A: positions t + L*k.  Pass B:
// L*b + j + S*k with t = b*S + j.  Pass C: runs of max(4, S) consecutive
// coefficients.  A block transforms POLYS polynomials at once with T threads;
// outside the transforms a thread owns E consecutive coefficients of every
// polynomial (in the MAC only at two ciphertexts a block).  At N = 2048 a block has 4 polynomials
// (8 would need 1,024 threads and twice the registers an SM has) and a ring
// of 2 BK rows, elsewhere 8 and a ring of 4; the ring's slots lie on the
// exchange buffers' halves, the first EARLY of them on the x0 halves.
template <int N>
struct Geo {
  static constexpr int L = N / kPer;    // threads a polynomial (64 at N = 1024)
  static constexpr int S = L / kPer;    // 8, 4, 2, 1 at N = 2048, 1024, 512, 256
  static constexpr int LOG_L = ilog2(L);
  static constexpr int LOG_S = ilog2(S);
  static constexpr int POLYS = N <= 1024 ? 8 : 4;
  static constexpr int T = POLYS * L;   // threads a block: N/2, or N/4 at 2048
  static constexpr int E = N / T;       // 2, or 4 at 2048
  static constexpr int RING = N <= 1024 ? 4 : 2;  // BK rows in flight in the MAC
  static constexpr int EARLY = POLYS / 4;  // ring slots on the x0 halves
  static constexpr bool RESIDENT = N <= 1024;  // every prime's stage tables may stay
  static constexpr int XW = N + kPer * S;  // words of one exchange buffer
  static_assert(S == 1 || S == 2 || S == 4 || S == 8, "N is 256, 512, 1024 or 2048");
  static_assert(RING * 4 == POLYS * 2 && N <= XW, "a slot takes four halves of two limbs each");
  // exchange address of coefficient `pos`: S words of padding every L
  __device__ static __forceinline__ int addr(int pos) { return pos + ((pos >> LOG_L) << LOG_S); }
  // The BK ring: limb polynomial o (0..7) of slot s, N/2 words of residue
  // pairs, starts at word slot(s) + limb(o).  Slot s takes halves 4s ..
  // 4s + 3 in the order x0 of every polynomial, then x1 of every polynomial,
  // two limb polynomials a half (2 * N/2 <= XW words).  So slots 0 .. EARLY - 1
  // lie on x0, free as soon as pass B of the last forward transforms has
  // read it: a chunk's first EARLY key rows fly during pass C.
  __host__ __device__ static constexpr int slot(int s) {
    return (4 * s % POLYS) * 2 * XW + (4 * s / POLYS) * XW;
  }
  __host__ __device__ static constexpr int limb(int o) {
    return (o >> 1) * 2 * XW + (o & 1) * (N / 2);
  }
};

// Four forward (decimation in frequency) stages on v[16]: pairs k, k + D for
// D = 8, 4, 2, 1, half-span h = D * stride.  `tab` is the forward stage
// table, `base` this thread's position below `stride`, M = B0 * 2^s for the
// first of the four stages s: a multiple of p above every value entering it.
template <int N>
__device__ __forceinline__ void fwd_stages(uint32_t (&v)[kPer], const uint2* tab, int base,
                                           int stride, uint32_t M, uint32_t p) {
#pragma unroll
  for (int D = 8; D >= 1; D >>= 1) {
    const uint2* w = tab + (N - 2 * D * stride) + base;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k & D) continue;
      const uint2 tw = w[stride * (k & (D - 1))];
      const uint32_t x = v[k], y = v[k + D];
      v[k] = x + y;                        // < 2M
      v[k + D] = shoup(x - y + M, tw, p);  // x - y + M in (0, 2M); result < 2p
    }
    M <<= 1;
  }
}

// Four inverse (decimation in time) stages: D = 1, 2, 4, 8.
template <int N>
__device__ __forceinline__ void inv_stages(uint32_t (&v)[kPer], const uint2* tab, int base,
                                           int stride, uint32_t p) {
#pragma unroll
  for (int D = 1; D <= 8; D <<= 1) {
    const uint2* w = tab + (D * stride - 1) + base;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k & D) continue;
      const uint2 tw = w[stride * (k & (D - 1))];
      const uint32_t x = v[k];
      const uint32_t t = shoup(v[k + D], tw, p);  // < 2p
      v[k] = x + t;           // grows by 2p a stage
      v[k + D] = x - t + 2 * p;
    }
  }
}

// Forward negacyclic NTT of one polynomial by the L threads that share it
// (natural order in, bit-reversed out, = ntt.ntt_device).  load(pos, tw)
// gives the coefficient times its twist tw = (psi^pos, Shoup companion) as a
// value congruent mod p and below B0, a multiple of p with B0 * N <= 2^32 (a
// value entering stage s is then below B0 * 2^s); store4(pos, a, b, c, d)
// takes the residues, in [0, p), of positions pos .. pos + 3.  `twist` is the
// global twist table,
// `stage` the forward stage table in shared memory, x0 and x1 this
// polynomial's exchange buffers.  Every thread of the block calls this
// (two __syncthreads() inside); `active` is uniform over the L threads.
// after_b() runs in every thread after the second barrier, where no thread
// reads any polynomial's x0 again (K4 starts a chunk's first key rows there).
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};
template <int N, class Load, class Store4, class AfterB = NoHook>
__device__ __forceinline__ void ntt_fwd(const Load& load, const Store4& store4, bool active,
                                        const uint2* __restrict__ twist, const uint2* stage,
                                        uint32_t* x0, uint32_t* x1, Mod md, uint32_t B0,
                                        const AfterB& after_b = AfterB()) {
  using G = Geo<N>;
  const int t = threadIdx.x & (G::L - 1);
  const uint32_t p = md.p;
  uint32_t v[kPer];
  if (active) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int pos = t + G::L * k;
      v[k] = load(pos, __ldg(twist + pos));  // < B0
    }
    fwd_stages<N>(v, stage, t, G::L, B0, p);  // stages 0..3
#pragma unroll
    for (int k = 0; k < kPer; ++k) x0[t + (G::L + G::S) * k] = v[k];
  }
  __syncthreads();
  const int b = t >> G::LOG_S, j = t & (G::S - 1);
  const int rb = (G::L + G::S) * b + j;
  if (active) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = x0[rb + G::S * k];
    fwd_stages<N>(v, stage, j, G::S, B0 << 4, p);  // stages 4..7
#pragma unroll
    for (int k = 0; k < kPer; ++k) x1[rb + G::S * k] = v[k];
  }
  __syncthreads();
  after_b();
  if (active) {
    if constexpr (G::S == 8) {
      // stages 8..10 on two runs of eight; the first twiddle of every stage
      // is 1: those differences stay as they are, below 2M like the sums
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int pos = 8 * (t + G::L * g);
        const uint4 qa = *reinterpret_cast<const uint4*>(x1 + G::addr(pos));
        const uint4 qb = *reinterpret_cast<const uint4*>(x1 + G::addr(pos) + 4);
        uint32_t u[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        uint32_t M = B0 << 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // half-span 4: twiddles stage[N - 8 + e]
          const uint32_t x = u[e], y = u[e + 4];
          u[e] = x + y;
          u[e + 4] = e == 0 ? x - y + M : shoup(x - y + M, stage[N - 8 + e], p);
        }
        M <<= 1;
#pragma unroll
        for (int e = 0; e < 8; ++e) {  // half-span 2: twiddles 1 and stage[N - 3]
          if (e & 2) continue;
          const uint32_t x = u[e], y = u[e + 2];
          u[e] = x + y;
          u[e + 2] = (e & 1) ? shoup(x - y + M, stage[N - 3], p) : x - y + M;
        }
        M <<= 1;
#pragma unroll
        for (int e = 0; e < 8; e += 2) {  // half-span 1: twiddle 1
          const uint32_t x = u[e], y = u[e + 1];
          u[e] = x + y;
          u[e + 1] = x - y + M;
        }
        // every value is < B0 * N <= 2^32
        store4(pos, reduce(u[0], md), reduce(u[1], md), reduce(u[2], md), reduce(u[3], md));
        store4(pos + 4, reduce(u[4], md), reduce(u[5], md), reduce(u[6], md), reduce(u[7], md));
      }
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int pos = 4 * (t + G::L * g);
        uint32_t u[4];
        if (G::S == 4) {
          const uint4 q = *reinterpret_cast<const uint4*>(x1 + G::addr(pos));
          u[0] = q.x, u[1] = q.y, u[2] = q.z, u[3] = q.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) u[e] = x1[G::addr(pos + e)];
        }
        uint32_t M = B0 << 8;
        // the first twiddle of every stage is 1: those differences stay as
        // they are, below 2M like the sums
        if (G::S == 4) {  // stage 8: half-span 2, twiddles 1 and w^(N/4)
          const uint32_t x0 = u[0], y0 = u[2], x1 = u[1], y1 = u[3];
          u[0] = x0 + y0;
          u[2] = x0 - y0 + M;
          u[1] = x1 + y1;
          u[3] = shoup(x1 - y1 + M, stage[N - 3], p);
          M <<= 1;
        }
        if (G::S >= 2) {  // last stage: half-span 1, twiddle 1
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const uint32_t x = u[e], y = u[e + 1];
            u[e] = x + y;
            u[e + 1] = x - y + M;
          }
        }
        // every value is < B0 * N <= 2^32
        store4(pos, reduce(u[0], md), reduce(u[1], md), reduce(u[2], md), reduce(u[3], md));
      }
    }
  }
}

// Inverse of ntt_fwd (bit-reversed in, natural out, with the psi^-j / N
// untwist, = ntt.intt_device).  load4(pos) gives positions pos .. pos + 3 as
// a uint4, each below 2p; store(pos, value) takes the residue in [0, p).
template <int N, class Load4, class Store>
__device__ __forceinline__ void ntt_inv(const Load4& load4, const Store& store, bool active,
                                        const uint2* __restrict__ untwist, const uint2* stage,
                                        uint32_t* x0, uint32_t* x1, Mod md) {
  using G = Geo<N>;
  const int t = threadIdx.x & (G::L - 1);
  const uint32_t p = md.p;
  uint32_t v[kPer];
  if (active) {
    if constexpr (G::S == 8) {
      // stages of half-span 1, 2, 4 on two runs of eight; the first twiddle
      // of every stage is 1: no product there
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int pos = 8 * (t + G::L * g);
        const uint4 qa = load4(pos), qb = load4(pos + 4);
        uint32_t u[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int e = 0; e < 8; e += 2) {  // half-span 1; inputs < 2p, outputs < 4p
          const uint32_t x = u[e], w = u[e + 1];
          u[e] = x + w;
          u[e + 1] = x - w + 2 * p;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {  // half-span 2, twiddles 1 and stage[2]; < 8p
          if (e & 2) continue;
          const uint32_t x = u[e];
          if (e & 1) {
            const uint32_t w = shoup(u[e + 2], stage[2], p);
            u[e] = x + w;
            u[e + 2] = x - w + 2 * p;
          } else {
            const uint32_t w = u[e + 2];
            u[e] = x + w;
            u[e + 2] = x - w + 4 * p;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // half-span 4, twiddles stage[3 + e]; < 16p
          const uint32_t x = u[e];
          if (e == 0) {
            const uint32_t w = u[4];
            u[0] = x + w;
            u[4] = x - w + 8 * p;
          } else {
            const uint32_t w = shoup(u[e + 4], stage[3 + e], p);
            u[e] = x + w;
            u[e + 4] = x - w + 2 * p;
          }
        }
        uint32_t* dst = x0 + G::addr(pos);
        *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
        *reinterpret_cast<uint4*>(dst + 4) = make_uint4(u[4], u[5], u[6], u[7]);
      }
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int pos = 4 * (t + G::L * g);
        const uint4 q = load4(pos);
        uint32_t u[4] = {q.x, q.y, q.z, q.w};
        // the first twiddle of every stage is 1: no product there
        if (G::S >= 2) {  // first stage: half-span 1, twiddle 1; inputs < 2p
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const uint32_t x = u[e], w = u[e + 1];
            u[e] = x + w;  // < 4p
            u[e + 1] = x - w + 2 * p;
          }
        }
        if (G::S == 4) {  // half-span 2, twiddles 1 and w^-(N/4); outputs < 8p
          const uint32_t x0 = u[0], w0 = u[2], x1 = u[1], w1 = shoup(u[3], stage[2], p);
          u[0] = x0 + w0;
          u[2] = x0 - w0 + 4 * p;
          u[1] = x1 + w1;
          u[3] = x1 - w1 + 2 * p;
        }
        uint32_t* dst = x0 + G::addr(pos);
        if (G::S == 4) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) x0[G::addr(pos + e)] = u[e];
        }
      }
    }
  }
  __syncthreads();
  const int b = t >> G::LOG_S, j = t & (G::S - 1);
  const int rb = (G::L + G::S) * b + j;
  if (active) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = x0[rb + G::S * k];
    inv_stages<N>(v, stage, j, G::S, p);
#pragma unroll
    for (int k = 0; k < kPer; ++k) x1[rb + G::S * k] = v[k];
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = x1[t + (G::L + G::S) * k];
    inv_stages<N>(v, stage, t, G::L, p);  // every value < 32p
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int pos = t + G::L * k;
      store(pos, csub(shoup(v[k], __ldg(untwist + pos), p), p));
    }
  }
}

constexpr int kMaxPrimes = 3;

struct Crt {
  uint32_t p[kMaxPrimes];
  Mod m[kMaxPrimes];
  // products of two residues that fit a uint32 beside a carried value below
  // 2p, per prime: floor((2^32 - 2p) / (p - 1)^2); 28 at 12289, 12 at 18433,
  // 2 at 40961
  int lazy[kMaxPrimes];
  uint2 inv01;   // p0^-1 mod p1 and its Shoup companion
  uint2 inv012;  // (p0 p1)^-1 mod p2 and its companion (three primes)
  uint32_t p01;  // p0 * p1 < 2^30
  unsigned long long all;  // the product of every prime
};

// The modulus and the lazy count of prime pi, by selects: indexing the
// kernel parameter's arrays with a loop variable would copy the struct to
// the stack.
__device__ __forceinline__ Mod crt_mod(const Crt& c, int pi) {
  return pi == 0 ? c.m[0] : pi == 1 ? c.m[1] : c.m[2];
}
__device__ __forceinline__ int crt_lazy(const Crt& c, int pi) {
  return pi == 0 ? c.lazy[0] : pi == 1 ? c.lazy[1] : c.lazy[2];
}

// Signed CRT value of residues mod two or three primes as a torus32 (mod
// 2^32).  Garner's digits stay below their primes; the value v lies in
// [0, P), and v >= P/2 stands for v - P, decided exactly (in 64 bits for three
// primes, P ~ 9.3e12).  The external product is bounded by
// rows * N * (Bg/2) * 128 < P/2 (ntt.primes_for), so this agrees with the
// fp32 sign estimate of the JAX package on every reachable value.
__device__ __forceinline__ uint32_t crt2(uint32_t c0, uint32_t c1, const Crt& c) {
  // Garner digit (c1 - c0) / p0 mod p1; c0 < p0 < p1 needs no reduction mod p1
  const uint32_t t1 = csub(shoup(c1 + c.p[1] - c0, c.inv01, c.p[1]), c.p[1]);
  uint32_t v = c0 + t1 * c.p[0];
  if (2 * v >= c.p01) v -= c.p01;
  return v;
}

__device__ __forceinline__ uint32_t crt3(uint32_t c0, uint32_t c1, uint32_t c2, const Crt& c) {
  const uint32_t t1 = csub(shoup(c1 + c.p[1] - c0, c.inv01, c.p[1]), c.p[1]);
  const uint32_t v01 = c0 + t1 * c.p[0];  // < p0 p1
  const uint32_t r = reduce(v01, c.m[2]);
  const uint32_t t2 = csub(shoup(c2 + c.p[2] - r, c.inv012, c.p[2]), c.p[2]);
  const unsigned long long v = v01 + static_cast<unsigned long long>(t2) * c.p01;  // < P
  return static_cast<uint32_t>(2 * v >= c.all ? v - c.all : v);
}

// Shared memory of G ciphertexts of a block, P primes, D differences a
// round (1, or 3 for a bundled round), digit rows transformed and multiplied
// `cr` at a time; all offsets are multiples of 16 bytes.  r1 holds a chunk's
// G * cr digit rows and then, unless they lie on the differences (on_diff),
// the last prime's G * 8 MAC sums.
template <int G>
__host__ __device__ constexpr int r1_rows(int cr, bool on_diff) {
  return G * (on_diff || cr > 8 ? cr : 8);
}

// Bytes of Smem<N, G, P, D> with the stage tables of tp primes, the
// accumulators in their own words (alias false) or on r2 (true), and the
// last prime's MAC sums in r1 (on_diff false) or on the differences (true).
template <int N, int G, int P, int D>
__host__ __device__ constexpr size_t smem_bytes(int tp, int cr, bool alias, bool on_diff) {
  return sizeof(uint2) * tp * 2 * N +
         sizeof(uint32_t) * (Geo<N>::POLYS * 2 * Geo<N>::XW + (alias ? D : 1 + D) * G * 2 * N) +
         sizeof(uint16_t) * (static_cast<size_t>(r1_rows<G>(cr, on_diff)) * N +
                             static_cast<size_t>(P - 1) * G * 8 * N);
}

template <int N, int G, int P, int D>
struct Smem {
  using Ge = Geo<N>;
  static constexpr int SMALLEST = Ge::POLYS / G;  // the smallest chunk of digit rows
  // The first of these layouts that fits at the smallest chunk of digit
  // rows, each giving up one more region of its own:
  // * every prime's stage tables stay (N <= 1024);
  // * one prime's at a time (RES false), each half refilled with the next
  //   prime's by cp.async as soon as it is dead (refill_half);
  // * the accumulators on r2, which is idle between rounds (ALIAS): in a
  //   round each thread carries the accumulator words it adds to in
  //   registers from before the differences are written until the CRT has
  //   read r2;
  // * the last prime's MAC sums on the differences, dead once that prime's
  //   last forward transforms have cut their digits (ON_DIFF; a bundled
  //   round's three differences hold them: 3 * G * 2 * N words against
  //   G * 8 * N halves), so that r1 holds only the chunk's digit rows.
  static constexpr bool RES =
      Ge::RESIDENT && smem_bytes<N, G, P, D>(P, SMALLEST, false, false) <= kMaxSmem;
  static constexpr int TP = RES ? P : 1;  // primes whose tables stay
  static constexpr bool ALIAS = smem_bytes<N, G, P, D>(TP, SMALLEST, false, false) > kMaxSmem;
  static constexpr bool ON_DIFF =
      D == 3 && ALIAS && smem_bytes<N, G, P, D>(TP, SMALLEST, true, false) > kMaxSmem;
  static_assert((P - 1) * G * 8 * N * 2 >= G * 2 * N * 4, "r2 holds the accumulators");
  static_assert(!ON_DIFF || D * G * 2 * N * 4 >= G * 8 * N * 2, "the differences hold the sums");
  uint2* stage;     // [TP][2: forward, inverse][N]
  uint32_t* ex;     // [POLYS][2][XW] exchange buffers, the BK ring in the MAC
  uint32_t* acc;    // [G][2][N] accumulators (unused by external_product); on r2 if ALIAS
  uint32_t* diff;   // [G][D][2][N] X^t acc - acc + gadget offset (likewise)
  uint16_t* r1;     // [r1_rows][N]: the chunk's digit rows in the NTT domain, the last prime's sums
  uint16_t* r2;     // [P - 1][G * 8][N]: the MAC sums of all primes but the last, inverted in place
  uint16_t* last;   // [G * 8][N]: the last prime's MAC sums, inverted in place (r1 or diff)
  __host__ __device__ static constexpr size_t bytes(int cr) {
    return smem_bytes<N, G, P, D>(TP, cr, ALIAS, ON_DIFF);
  }
  __device__ Smem(unsigned char* base, int cr) {
    stage = reinterpret_cast<uint2*>(base);
    ex = reinterpret_cast<uint32_t*>(stage + TP * 2 * N);
    acc = ex + Ge::POLYS * 2 * Ge::XW;
    diff = ALIAS ? acc : acc + G * 2 * N;
    r1 = reinterpret_cast<uint16_t*>(diff + D * G * 2 * N);
    r2 = r1 + static_cast<size_t>(r1_rows<G>(cr, ON_DIFF)) * N;
    last = ON_DIFF ? reinterpret_cast<uint16_t*>(diff) : r1;
    if (ALIAS) acc = reinterpret_cast<uint32_t*>(r2);
  }
};

// Copy the forward and inverse stage tables of primes 0 .. np - 1 into
// shared memory.  tabs: uint2 [P][4][N] in global memory.  Ends with a
// barrier.
template <int N>
__device__ __forceinline__ void stage_tables(uint2* stage, const uint2* __restrict__ tabs,
                                             int np) {
  for (int i = threadIdx.x; i < np * 2 * N; i += Geo<N>::T) {
    const int pi = i / (2 * N), dir = (i / N) & 1, k = i & (N - 1);
    stage[i] = tabs[(pi * 4 + 1 + 2 * dir) * N + k];
  }
  __syncthreads();
}

// Half `dir` (0 forward, 1 inverse) of a one-prime stage region takes prime
// pi's table, N uint2 in 16-byte cp.async, each thread its own N/T of them;
// not committed: the caller's next cp_async_commit() puts the copies in a
// group of the key ring, so the ring's waits cover them and no barrier is
// added.
template <int N>
__device__ __forceinline__ void refill_half(uint2* stage, const uint2* __restrict__ tabs, int pi,
                                            int dir) {
  constexpr int PER = N / Geo<N>::T;  // uint2 a thread
  static_assert(PER % 2 == 0, "whole 16-byte copies");
  const int i = threadIdx.x * PER;
  const uint2* src = tabs + (pi * 4 + 1 + 2 * dir) * N + i;
  const uint32_t dst = shared_address(stage + dir * N + i);
#pragma unroll
  for (int k = 0; k < PER / 2; ++k) cp_async<16>(dst + 16u * k, src + 2 * k);
}

// TGSW external products of this block's G ciphertexts:
//   delta[g][u] = sum_rows digit_row (x) BK[row][u]  (mod 2^32, u = 0, 1)
// over `rows` digit rows (3 * 2l for a bundled round), `cr` of them
// transformed and then multiplied at a time.  digit(g, j, pos) gives row j's
// signed digit of ciphertext g at coefficient pos, |digit| < p;
// digit.small_bias(p) is (Bg/2) * p where every digit lies in [-Bg/2, Bg/2)
// and Bg * p * N < 2^32, else 0.  bk points at the round slice of prime 0,
// int16 [rows][8][N] residues read as 16-bit patterns; prime i's slice is
// i * prime_stride elements further.  On return delta[g][u][e] holds
// coefficient E*tid + e.  The caller puts a barrier between its own
// shared-memory writes and this call; after its last barrier the function
// only reads r2 and sm.last.
template <int N, int G, int P, int D, class DigitFn>
__device__ __forceinline__ void external_product_block(
    const DigitFn& digit, int rows, int cr, const int16_t* __restrict__ bk,
    long long prime_stride, const uint2* __restrict__ tabs, const Crt& crt,
    const Smem<N, G, P, D>& sm, uint32_t (&delta)[G][2][Geo<N>::E]) {
  using Ge = Geo<N>;
  using S = Smem<N, G, P, D>;
  constexpr int E = Ge::E, RING = Ge::RING, EARLY = Ge::EARLY;
  // The key ring: each thread copies coefficients cb .. cb + 7 of the E limb
  // polynomials HG * q + h (q < E) of a key row, 16 contiguous bytes each;
  // LS lanes of a warp share h and cover 8 * LS coefficients.  At one
  // ciphertext a block (RUNS) it multiplies just those (the digits and the
  // sums likewise in 16-byte runs); at two (N <= 1024) it multiplies
  // coefficients E*tid .. E*tid + E - 1 of all eight limb polynomials, which
  // its warp's lanes copied (a __syncwarp after the wait and before a slot's
  // refill), so that a digit it loads serves eight products, not E.
  constexpr int HG = 8 / E, LS = 32 / HG;
  constexpr bool RUNS = G == 1;
  static_assert(RUNS || E == 2, "two ciphertexts a block at N <= 1024 only");
  const int tid = threadIdx.x;
  const int grp = tid / Ge::L;
  uint32_t* x0 = sm.ex + grp * 2 * Ge::XW;
  uint32_t* x1 = x0 + Ge::XW;
  const int h = (tid & 31) / LS;
  const int cb = (tid >> 5) * 8 * LS + 8 * (tid & (LS - 1));
  const uint32_t* ring = sm.ex + Ge::limb(h) + cb / 2;  // limb HG * q + h is q * HG * XW further
  const uint32_t ring_addr = shared_address(ring);
  const uint16_t* ringw = reinterpret_cast<const uint16_t*>(sm.ex + tid);  // E == 2: word tid
#pragma unroll 1
  for (int pi = 0; pi < P; ++pi) {
    const Mod md = crt_mod(crt, pi);
    const uint32_t p = md.p;
    const uint2* tab = tabs + pi * 4 * N;
    const uint2* stage = sm.stage + (S::RES ? pi * 2 * N : 0);
    if constexpr (!S::RES) {
      // the inverse half holds the last prime's table, dead since the
      // barrier that ended its inverse transforms: this prime's lands during
      // the forward transforms, and the MAC's first wait covers it
      refill_half<N>(sm.stage, tabs, pi, 1);
      cp_async_commit();
    }
    const uint32_t bias = digit.small_bias(p);
    // MAC accumulators of ciphertext g: a[g][8 * q + e] sums coefficient
    // cb + e of limb polynomial HG * q + h (RUNS), else a[g][E * o + e]
    // coefficient E*tid + e of limb polynomial o; each BK residue is fetched
    // once for all G.  `lazy` products of residues fit a uint32 beside a
    // carried value < 2p, so the sums are reduced (to [0, 2p)) only before
    // the product that would not fit, and at the end.
    uint32_t a[G][8 * E];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < 8 * E; ++k) a[g][k] = 0u;
    const int lazy = crt_lazy(crt, pi);
    int pending = 0;
    // The exchange buffers are idle in the MAC and serve as a ring of RING
    // rows of BK (Geo::slot, Geo::limb): a thread copies E runs of 16 bytes
    // a row, each by one cp.async.cg, which keeps the rows out of L1, where
    // the transforms read their twists; RING - 1 rows ahead of the row it
    // multiplies, which keeps the L2 latency out of the loop, and no block
    // barrier: a thread reads only its own words (RUNS) or its warp's.
    const uint32_t* bkw = reinterpret_cast<const uint32_t*>(bk + pi * prime_stride) +
                          h * (N / 2) + cb / 2;
    const auto fetch = [&](int row, int s) {  // s is a constant where this is called
      const uint32_t* src = bkw + row * 8 * (N / 2);
#pragma unroll
      for (int q = 0; q < E; ++q)
        cp_async<16>(ring_addr + 4u * (Ge::slot(s) + q * HG * Ge::XW), src + q * HG * (N / 2));
      cp_async_commit();
    };

#pragma unroll 1
    for (int c0 = 0; c0 < rows; c0 += cr) {
      const int cn = rows - c0 < cr ? rows - c0 : cr;
      // forward transforms of this chunk's G * cn digit polynomials, POLYS
      // at a time; polynomial q is row c0 + q % cn of ciphertext q / cn
#pragma unroll 1
      for (int q0 = 0; q0 < G * cn; q0 += Ge::POLYS) {
        const int q = q0 + grp;
        const int g = q / cn, j = c0 + q - g * cn;
        uint16_t* slot = sm.r1 + static_cast<size_t>(q) * N;
        // the chunk's first EARLY key rows fly into the slots on the x0
        // halves during pass C of the chunk's last forward batch
        const bool last_batch = q0 + Ge::POLYS >= G * cn;
        const auto start_rows = [&] {
          if (last_batch) {
#pragma unroll
            for (int r = 0; r < EARLY; ++r)
              if (r < cn) fetch(c0 + r, r);
          }
        };
        const auto store = [&](int pos, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
          *reinterpret_cast<uint2*>(slot + pos) = make_uint2(a | (b << 16), c | (d << 16));
        };
        if (bias != 0u) {
          // digits in [-Bg/2, Bg/2): d * psi^pos + (Bg/2) * p is in [0, Bg * p),
          // one multiply-add and no reduction
          ntt_fwd<N>(
              [&](int pos, uint2 tw) {
                return static_cast<uint32_t>(digit(g, j, pos)) * tw.x + bias;
              },
              store, q < G * cn, tab, stage, x0, x1, md, 2 * bias, start_rows);
        } else {
          ntt_fwd<N>(
              [&](int pos, uint2 tw) {
                const int d = digit(g, j, pos);
                return shoup(static_cast<uint32_t>(d < 0 ? d + static_cast<int>(p) : d), tw, p);
              },
              store, q < G * cn, tab, stage, x0, x1, md, 2 * p, start_rows);
        }
      }
      __syncthreads();

      // MAC over the chunk's rows.  Rows c0 .. c0 + EARLY - 1 are in flight.
      // After the prime's last forward transforms (the barrier above) the
      // forward half of the tables is dead: the next prime's table (the next
      // round's first) rides with the chunk's next row, or alone
      const bool refill = !S::RES && c0 + cn == rows;
      if (refill) refill_half<N>(sm.stage, tabs, pi + 1 < P ? pi + 1 : 0, 0);
#pragma unroll
      for (int r = EARLY; r < RING; ++r)
        if (r < cn) fetch(c0 + r, r);
      if (refill && cn <= EARLY) cp_async_commit();
#pragma unroll 1
      for (int j0 = 0; j0 < cn; j0 += RING) {
#pragma unroll
        for (int jj = 0; jj < RING; ++jj) {
          const int j = j0 + jj;
          if (j < cn) {
            // rows j .. min(j + RING - 1, cn - 1) are in flight, the table's
            // refill with them: row j must have landed
            cp_async_wait_upto<RING>(cn - 1 - j);
            if (pending == lazy) {
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int k = 0; k < 8 * E; ++k) a[g][k] = reduce_2p(a[g][k], md);
              pending = 0;
            }
            ++pending;
            if constexpr (RUNS) {
              const uint4 dq = *reinterpret_cast<const uint4*>(sm.r1 + j * N + cb);
              const uint32_t dw[4] = {dq.x, dq.y, dq.z, dq.w};
              uint32_t d[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) d[e] = e & 1 ? dw[e / 2] >> 16 : dw[e / 2] & 0xffffu;
#pragma unroll
              for (int q = 0; q < E; ++q) {
                const uint4 wq =
                    *reinterpret_cast<const uint4*>(ring + Ge::slot(jj) + q * HG * Ge::XW);
                const uint32_t ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  const uint32_t w = e & 1 ? ww[e / 2] >> 16 : ww[e / 2] & 0xffffu;
                  a[0][8 * q + e] += d[e] * w;
                }
              }
            } else {
              __syncwarp();  // the warp's copies of row j have all landed
              uint32_t d[G][E];
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int e = 0; e < E; ++e) d[g][e] = sm.r1[(g * cn + j) * N + E * tid + e];
#pragma unroll
              for (int o = 0; o < 8; ++o)
#pragma unroll
                for (int e = 0; e < E; ++e) {
                  const uint32_t w = ringw[2 * (Ge::slot(jj) + Ge::limb(o)) + e];
#pragma unroll
                  for (int g = 0; g < G; ++g) a[g][E * o + e] += d[g][e] * w;
                }
            }
            // Refill the slot just read: with RUNS nobody else touches this
            // thread's words; else its warp's lanes have read them after the
            // __syncwarp.  Read-then-asynchronous-write is safe: the "memory"
            // clobber of cp_async keeps the compiler from moving the copy
            // above the loads of the row, the SM issues a thread's shared loads
            // and its cp.async through one in-order pipe, and a load has picked
            // its data up long before the copy's global read can come back.
            if (j + RING < cn) {
              if constexpr (!RUNS) __syncwarp();
              fetch(c0 + j + RING, jj);
            }
          }
        }
      }
      __syncthreads();  // the chunk's digit rows and the ring are free again
    }
    // the MAC sums go where they are inverse-transformed: r2 for all primes
    // but the last, sm.last for the last; below 2p < 2^16 each (below p for
    // a prime above 2^15, so that they fit 16 bits)
    uint16_t* sums = pi == P - 1 ? sm.last : sm.r2 + static_cast<size_t>(pi) * G * 8 * N;
    const bool wide = p >= (1u << 15);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t f[8 * E];
#pragma unroll
      for (int k = 0; k < 8 * E; ++k) f[k] = wide ? reduce(a[g][k], md) : reduce_2p(a[g][k], md);
#pragma unroll
      for (int k = 0; k < 8 * E; k += 8) {
        if constexpr (RUNS)  // coefficients cb .. cb + 7 of limb polynomial HG * q + h
          *reinterpret_cast<uint4*>(sums + (HG * (k / 8) + h) * N + cb) =
              make_uint4(f[k] | (f[k + 1] << 16), f[k + 2] | (f[k + 3] << 16),
                         f[k + 4] | (f[k + 5] << 16), f[k + 6] | (f[k + 7] << 16));
        else  // coefficients E*tid, E*tid + 1 of limb polynomials k/2 .. k/2 + 3
#pragma unroll
          for (int o = k / 2; o < k / 2 + 4; ++o)
            *reinterpret_cast<uint32_t*>(sums + (g * 8 + o) * N + E * tid) =
                f[E * o] | (f[E * o + 1] << 16);
      }
    }
    __syncthreads();

    // inverse transforms of the G * 8 sums, in place
#pragma unroll 1
    for (int q0 = 0; q0 < G * 8; q0 += Ge::POLYS) {
      uint16_t* row = sums + static_cast<size_t>(q0 + grp) * N;
      ntt_inv<N>(
          [&](int pos) {
            const uint2 w = *reinterpret_cast<const uint2*>(row + pos);
            return make_uint4(w.x & 0xffffu, w.x >> 16, w.y & 0xffffu, w.y >> 16);
          },
          [&](int pos, uint32_t v) { row[pos] = static_cast<uint16_t>(v); },
          true, tab + 2 * N, stage + N, x0, x1, md);
    }
    __syncthreads();
  }
  // CRT and the recombination of the 4 BK limbs
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) delta[g][u][e] = 0u;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int k = (g * 8 + o) * N + E * tid + e;
        uint32_t v;
        if constexpr (P == 2)
          v = crt2(sm.r2[k], sm.last[k], crt);
        else
          v = crt3(sm.r2[k], sm.r2[G * 8 * N + k], sm.last[k], crt);
        delta[g][o / 4][e] += v << (8 * (o % 4));
      }
    }
  }
}

struct Gadget {
  int l, bg_bit;
  uint32_t offset;  // sum_j (Bg/2) * 2^(32 - (j+1)*bg_bit), as uint32
  int small;        // Bg * p * N < 2^32 for every prime: the twist needs no reduction
};

Gadget make_gadget(int l, int bg_bit, uint32_t offset, int max_prime, int N) {
  const unsigned long long p = static_cast<unsigned long long>(max_prime);
  return Gadget{l, bg_bit, offset, ((p * N) << bg_bit) < 0x100000000ull};
}

// X^t a [k] = +-a[(k - t) mod N], negated when (k - t) mod 2N >= N; t in [0, 2N).
template <int N>
__device__ __forceinline__ uint32_t rotated(const uint32_t* a, int t, int k) {
  int src = k - t;
  if (src < 0) src += 2 * N;
  const bool neg = src >= N;
  src = neg ? src - N : src;
  return neg ? 0u - a[src] : a[src];
}

// u = X^t acc - acc + gadget offset for the block's G ciphertexts, from the
// accumulators in shared memory into sm.diff.  t[c] in [0, 2N).  Ends with a
// barrier.
template <int N, int G, int P>
__device__ __forceinline__ void rotate_diff(const Smem<N, G, P, 1>& sm, const int (&t)[G],
                                            uint32_t offset) {
#pragma unroll
  for (int c = 0; c < G; ++c)
#pragma unroll
    for (int e = 0; e < Geo<N>::E; ++e) {
      const int k = threadIdx.x + e * Geo<N>::T;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t* a = sm.acc + (c * 2 + u) * N;
        sm.diff[(c * 2 + u) * N + k] = rotated<N>(a, t[c], k) - a[k] + offset;
      }
    }
  __syncthreads();
}

// The three differences of a bundled round, plus the gadget offset:
// u = X^ti acc - acc, v = X^tj acc - acc and w = X^tj u - u, which is
// X^(ti+tj) acc - X^ti acc - X^tj acc + acc (mod 2^32), so all three come
// from the accumulators in one pass.  sm.diff is [G][3][2][N].  Ends with a
// barrier.
template <int N, int G, int P>
__device__ __forceinline__ void rotate_diff3(const Smem<N, G, P, 3>& sm, const int (&ti)[G],
                                             const int (&tj)[G], uint32_t offset) {
#pragma unroll
  for (int c = 0; c < G; ++c) {
    int tij = ti[c] + tj[c];
    if (tij >= 2 * N) tij -= 2 * N;
#pragma unroll
    for (int e = 0; e < Geo<N>::E; ++e) {
      const int k = threadIdx.x + e * Geo<N>::T;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t* a = sm.acc + (c * 2 + u) * N;
        const uint32_t ak = a[k], xi = rotated<N>(a, ti[c], k), xj = rotated<N>(a, tj[c], k);
        const uint32_t xij = rotated<N>(a, tij, k);
        sm.diff[((c * 3 + 0) * 2 + u) * N + k] = xi - ak + offset;
        sm.diff[((c * 3 + 1) * 2 + u) * N + k] = xj - ak + offset;
        sm.diff[((c * 3 + 2) * 2 + u) * N + k] = xij - xi - xj + ak + offset;
      }
    }
  }
  __syncthreads();
}

// Signed gadget digits of the values rotate_diff (D = 1) or rotate_diff3
// (D = 3) left in shared memory.  Row j = which * 2l + bloc * l + level.
template <int N, int D>
struct GadgetDigits {
  const uint32_t* u;  // [G][D][2][N]
  Gadget g;
  __device__ __forceinline__ int operator()(int ct, int j, int pos) const {
    int which = 0;
    if (D == 3) {
      which = j / (2 * g.l);
      j -= which * 2 * g.l;
    }
    const int bloc = j / g.l, lv = j - bloc * g.l;
    const int shift = 32 - (lv + 1) * g.bg_bit;
    const uint32_t f =
        (u[((ct * D + which) * 2 + bloc) * N + pos] >> shift) & ((1u << g.bg_bit) - 1u);
    return static_cast<int>(f) - (1 << (g.bg_bit - 1));
  }
  __device__ __forceinline__ uint32_t small_bias(uint32_t p) const {
    return g.small ? p << (g.bg_bit - 1) : 0u;
  }
};

template <int N>
struct RowDigits {
  const int32_t* d;  // [rows][N] of this block's one ciphertext
  __device__ __forceinline__ int operator()(int, int j, int pos) const { return d[j * N + pos]; }
  __device__ __forceinline__ uint32_t small_bias(uint32_t) const { return 0u; }
};

// ---------------------------------------------------------------- kernels

// K1: POLYS rows a block; rows beyond M are masked.
template <int N>
__global__ void __launch_bounds__(Geo<N>::T) ntt_kernel(const int32_t* __restrict__ x,
                                                        int32_t* __restrict__ y,
                                                        const uint2* __restrict__ tab,
                                                        uint32_t p, int inverse, int M) {
  using Ge = Geo<N>;
  extern __shared__ uint4 smem_raw[];
  uint2* stage = reinterpret_cast<uint2*>(smem_raw);
  uint32_t* ex = reinterpret_cast<uint32_t*>(stage + N);
  const int tid = threadIdx.x, grp = tid / Ge::L;
  const long long row = static_cast<long long>(blockIdx.x) * Ge::POLYS + grp;
  const bool active = row < M;
  for (int i = tid; i < N; i += Ge::T) stage[i] = tab[(inverse ? 3 : 1) * N + i];
  __syncthreads();
  uint32_t* x0 = ex + grp * 2 * Ge::XW;
  uint32_t* x1 = x0 + Ge::XW;
  const Mod md = make_mod(p);
  const int32_t* xr = x + row * N;
  int32_t* yr = y + row * N;
  if (inverse) {
    ntt_inv<N>(
        [&](int pos) {
          const int4 q = *reinterpret_cast<const int4*>(xr + pos);
          return make_uint4(q.x, q.y, q.z, q.w);
        },
        [&](int pos, uint32_t v) { yr[pos] = static_cast<int32_t>(v); }, active, tab + 2 * N,
        stage, x0, x1, md);
  } else {
    ntt_fwd<N>([&](int pos, uint2 tw) { return shoup(static_cast<uint32_t>(xr[pos]), tw, p); },
               [&](int pos, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
                 *reinterpret_cast<int4*>(yr + pos) = make_int4(a, b, c, d);
               },
               active, tab, stage, x0, x1, md, 2 * p);
  }
}

template <int N>
__global__ void __launch_bounds__(Geo<N>::T) external_product_kernel(
    const int32_t* __restrict__ digits, const int16_t* __restrict__ bk, long long prime_stride,
    const uint2* __restrict__ tabs, int32_t* __restrict__ delta_out, int rows, Crt crt) {
  extern __shared__ uint4 smem_raw[];
  const Smem<N, 1, 2, 1> sm(reinterpret_cast<unsigned char*>(smem_raw), rows);
  stage_tables<N>(sm.stage, tabs, 2);
  const long long m = blockIdx.x;
  const RowDigits<N> dig{digits + m * rows * N};
  uint32_t delta[1][2][Geo<N>::E];
  external_product_block<N, 1, 2, 1>(dig, rows, rows, bk, prime_stride, tabs, crt, sm, delta);
#pragma unroll
  for (int u = 0; u < 2; ++u)
    *reinterpret_cast<int2*>(delta_out + (m * 2 + u) * N + 2 * threadIdx.x) =
        make_int2(delta[0][u][0], delta[0][u][1]);
}

template <int N>
__global__ void __launch_bounds__(Geo<N>::T) cmux_round_kernel(
    const int32_t* __restrict__ acc_in, const int32_t* __restrict__ t,
    const int16_t* __restrict__ bk, long long prime_stride, const uint2* __restrict__ tabs,
    int32_t* __restrict__ acc_out, Gadget g, Crt crt) {
  extern __shared__ uint4 smem_raw[];
  const int rows = 2 * g.l;
  const Smem<N, 1, 2, 1> sm(reinterpret_cast<unsigned char*>(smem_raw), rows);
  const long long m = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < 2 * N; k += Geo<N>::T)
    sm.acc[k] = static_cast<uint32_t>(acc_in[m * 2 * N + k]);
  stage_tables<N>(sm.stage, tabs, 2);  // ends with a barrier
  const int tt[1] = {t[m]};
  rotate_diff<N, 1, 2>(sm, tt, g.offset);
  const GadgetDigits<N, 1> dig{sm.diff, g};
  uint32_t delta[1][2][Geo<N>::E];
  external_product_block<N, 1, 2, 1>(dig, rows, rows, bk, prime_stride, tabs, crt, sm, delta);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int k = u * N + 2 * tid;
    *reinterpret_cast<int2*>(acc_out + m * 2 * N + k) =
        make_int2(sm.acc[k] + delta[0][u][0], sm.acc[k + 1] + delta[0][u][1]);
  }
}

// K4: block b owns ciphertexts b*G .. b*G + G - 1; those beyond B run on a
// zero accumulator and are not stored.  D = 1: n rounds of one exponent each
// (BK int16 [P][n][2l][8][N]); D = 3: n/2 bundled rounds on the exponent
// pairs (2i, 2i + 1) (BK [P][n/2][3 * 2l][8][N]).
template <int N, int G, int P, int D>
__global__ void __launch_bounds__(Geo<N>::T, 1) blind_rotate_kernel(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ abar,
    const int16_t* __restrict__ bk, const uint2* __restrict__ tabs,
    int32_t* __restrict__ acc_out, int B, int n, int cr, Gadget g, Crt crt) {
  using Ge = Geo<N>;
  using S = Smem<N, G, P, D>;
  constexpr int E = Ge::E;
  extern __shared__ uint4 smem_raw[];
  const int rows = D * 2 * g.l;
  const S sm(reinterpret_cast<unsigned char*>(smem_raw), cr);
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * G;
  const int rounds = D == 3 ? n / 2 : n;
  const long long round_stride = static_cast<long long>(rows) * 8 * N;
  const long long prime_stride = round_stride * rounds;
#pragma unroll
  for (int c = 0; c < G; ++c)
    for (int k = tid; k < 2 * N; k += Ge::T)
      sm.acc[c * 2 * N + k] =
          first + c < B ? static_cast<uint32_t>(acc0[(first + c) * 2 * N + k]) : 0u;
  if constexpr (S::RES) {
    stage_tables<N>(sm.stage, tabs, P);  // ends with a barrier
  } else {
    // the launch's one staging: prime 0's forward table (its inverse one
    // comes with the prime's refill)
    refill_half<N>(sm.stage, tabs, 0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const GadgetDigits<N, D> dig{sm.diff, g};
#pragma unroll 1
  for (int j = 0; j < rounds; ++j) {
    // ALIAS: this thread's accumulator words, carried while the round
    // overwrites r2 (the differences' reads of acc end at their barrier)
    uint32_t own[G][2][E];
    if constexpr (S::ALIAS) {
#pragma unroll
      for (int c = 0; c < G; ++c)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < E; ++e) own[c][u][e] = sm.acc[(c * 2 + u) * N + E * tid + e];
    }
    if constexpr (D == 1) {
      int tt[G];
#pragma unroll
      for (int c = 0; c < G; ++c) tt[c] = first + c < B ? abar[(first + c) * n + j] : 0;
      rotate_diff<N, G, P>(sm, tt, g.offset);
    } else {
      int ti[G], tj[G];
#pragma unroll
      for (int c = 0; c < G; ++c) {
        ti[c] = first + c < B ? abar[(first + c) * n + 2 * j] : 0;
        tj[c] = first + c < B ? abar[(first + c) * n + 2 * j + 1] : 0;
      }
      rotate_diff3<N, G, P>(sm, ti, tj, g.offset);
    }
    uint32_t delta[G][2][E];
    // reads sm.diff, never sm.acc, and only r2 and sm.last after its last barrier
    external_product_block<N, G, P, D>(dig, rows, cr, bk + j * round_stride, prime_stride, tabs,
                                       crt, sm, delta);
    if constexpr (S::ALIAS) {
      __syncthreads();  // every thread has read r2 for its CRT
#pragma unroll
      for (int c = 0; c < G; ++c)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < E; ++e)
            sm.acc[(c * 2 + u) * N + E * tid + e] = own[c][u][e] + delta[c][u][e];
    } else {
#pragma unroll
      for (int c = 0; c < G; ++c)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t* a = sm.acc + (c * 2 + u) * N + E * tid;
          if constexpr (E == 2) {
            const uint2 v = *reinterpret_cast<uint2*>(a);
            *reinterpret_cast<uint2*>(a) =
                make_uint2(v.x + delta[c][u][0], v.y + delta[c][u][1]);
          } else {
            const uint4 v = *reinterpret_cast<uint4*>(a);
            *reinterpret_cast<uint4*>(a) =
                make_uint4(v.x + delta[c][u][0], v.y + delta[c][u][1], v.z + delta[c][u][2],
                           v.w + delta[c][u][3]);
          }
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < G; ++c)
    if (first + c < B)
      for (int k = tid; k < 2 * N; k += Ge::T)
        acc_out[(first + c) * 2 * N + k] = static_cast<int32_t>(sm.acc[c * 2 * N + k]);
}

uint32_t powmod(uint32_t a, uint32_t e, uint32_t p) {
  unsigned long long r = 1, x = a % p;
  while (e) {
    if (e & 1) r = r * x % p;
    x = x * x % p;
    e >>= 1;
  }
  return static_cast<uint32_t>(r);
}

uint2 shoup_pair(uint32_t w, uint32_t p) {
  uint2 r;
  r.x = w;
  r.y = static_cast<uint32_t>((static_cast<unsigned long long>(w) << 32) / p);
  return r;
}

// Primes ascending (as ntt.primes_for gives them), each below 2^16 (a
// residue is a 16-bit pattern of the int16 BK).
bool primes_ok(int P, const int* p) {
  if (P < 2 || P > kMaxPrimes || p[0] <= 2) return false;
  for (int i = 1; i < P; ++i)
    if (p[i] <= p[i - 1]) return false;
  return p[P - 1] < (1 << 16);
}

Crt make_crt(int P, const int* pr) {
  Crt c{};
  for (int i = 0; i < P; ++i) {
    c.p[i] = static_cast<uint32_t>(pr[i]);
    c.m[i] = make_mod(c.p[i]);
    c.lazy[i] = static_cast<int>((0x100000000ull - 2 * c.p[i]) /
                                 ((c.p[i] - 1ull) * (c.p[i] - 1ull)));
  }
  c.inv01 = shoup_pair(powmod(c.p[0] % c.p[1], c.p[1] - 2, c.p[1]), c.p[1]);
  c.p01 = c.p[0] * c.p[1];
  c.all = static_cast<unsigned long long>(c.p01);
  if (P == 3) {
    c.inv012 = shoup_pair(powmod(c.p01 % c.p[2], c.p[2] - 2, c.p[2]), c.p[2]);
    c.all *= c.p[2];
  }
  return c;
}

// Whether a launch of the kernel with `bytes` of dynamic shared memory may
// go ahead: at most kMaxSmem, and within the limit the kernel was opted in
// to on this device (once; `state` is the instance's own).
template <class Kernel>
bool allow_smem(redsec::PerDevice& state, Kernel kernel, size_t bytes) {
  return bytes <= kMaxSmem && redsec::opt_in_smem(state, kernel, bytes) == cudaSuccess;
}

// Whether blind_rotate_kernel<N, G, P, D> is built: its shared memory fits
// at the smallest chunk of digit rows.
template <int N, int G, int P, int D>
constexpr bool k4_built() {
  return Smem<N, G, P, D>::bytes(Geo<N>::POLYS / G) <= kMaxSmem;
}

// The largest chunk of digit rows whose layout fits a block at G
// ciphertexts: all rows, else a multiple of POLYS / G (G * cr digit
// polynomials fill whole batches of transforms); 0 where none fits.
template <int N, int G, int P, int D>
int k4_chunk(int rows) {
  if constexpr (k4_built<N, G, P, D>()) {
    constexpr int step = Geo<N>::POLYS / G;
    int cr = rows;
    while (Smem<N, G, P, D>::bytes(cr) > kMaxSmem) cr = (cr - 1) / step * step;
    return cr;
  }
  return 0;
}

// How a launch of K4 runs, a function of the instance, the digit rows, the
// batch and the card's SM count only.  Two ciphertexts a block, so that one
// load of a key row serves both, when one a block would need more than one
// wave of blocks and two fit shared memory at some chunk of digit rows (the
// largest such chunk); else one.
struct K4Config {
  int G, cr;
  size_t bytes;
  bool resident;  // every prime's stage tables stay in shared memory (else one
                  // prime's, each half refilled off the block's path)
  bool alias;     // the accumulators lie on r2
  bool on_diff;   // the last prime's MAC sums lie on the differences
};

template <int N, int G, int P, int D>
K4Config k4_layout(int cr) {
  using S = Smem<N, G, P, D>;
  return K4Config{G, cr, S::bytes(cr), S::RES, S::ALIAS, S::ON_DIFF};
}

template <int N, int P, int D>
bool k4_config(int B, int rows, int sms, K4Config* out) {
  const int cr2 = k4_chunk<N, 2, P, D>(rows), cr1 = k4_chunk<N, 1, P, D>(rows);
  if (B > sms && cr2 > 0)
    *out = k4_layout<N, 2, P, D>(cr2);
  else if (cr1 > 0)
    *out = k4_layout<N, 1, P, D>(cr1);
  else
    return false;
  return true;
}

template <int N, int G, int P, int D>
int launch_blind_rotate(const K4Config& cf, const int32_t* acc0, const int32_t* abar,
                        const int16_t* bk, const uint2* tabs, int32_t* out, int B, int n,
                        Gadget g, Crt crt, cudaStream_t stream) {
  if constexpr (k4_built<N, G, P, D>()) {
    static redsec::PerDevice smem;
    if (!allow_smem(smem, blind_rotate_kernel<N, G, P, D>, cf.bytes))
      return static_cast<int>(cudaErrorInvalidValue);
    blind_rotate_kernel<N, G, P, D><<<(B + G - 1) / G, Geo<N>::T, cf.bytes, stream>>>(
        acc0, abar, bk, tabs, out, B, n, cf.cr, g, crt);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int N, int P, int D>
int dispatch_blind_rotate(const int32_t* acc0, const int32_t* abar, const int16_t* bk,
                          const uint2* tabs, int32_t* out, int B, int n, Gadget g, Crt crt,
                          cudaStream_t stream) {
  K4Config cf;
  if (!k4_config<N, P, D>(B, D * 2 * g.l, redsec::sm_count(), &cf))
    return static_cast<int>(cudaErrorInvalidValue);
  return cf.G == 2
             ? launch_blind_rotate<N, 2, P, D>(cf, acc0, abar, bk, tabs, out, B, n, g, crt, stream)
             : launch_blind_rotate<N, 1, P, D>(cf, acc0, abar, bk, tabs, out, B, n, g, crt, stream);
}

}  // namespace

#define REDSEC_DISPATCH_N(N_, ...)                             \
  switch (N_) {                                                 \
    case 256: { constexpr int NN = 256; __VA_ARGS__; break; }   \
    case 512: { constexpr int NN = 512; __VA_ARGS__; break; }   \
    case 1024: { constexpr int NN = 1024; __VA_ARGS__; break; } \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

// K4's instances: N, primes P, differences a round D.
#define REDSEC_DISPATCH_K4(N_, P_, D_, ...)                                   \
  do {                                                                          \
    const int key_ = (N_) * 100 + (P_) * 10 + (D_);                             \
    switch (key_) {                                                             \
      case 25621: { constexpr int NN = 256, PP = 2, DD = 1; __VA_ARGS__; }           \
      case 25631: { constexpr int NN = 256, PP = 3, DD = 1; __VA_ARGS__; }           \
      case 25623: { constexpr int NN = 256, PP = 2, DD = 3; __VA_ARGS__; }           \
      case 25633: { constexpr int NN = 256, PP = 3, DD = 3; __VA_ARGS__; }           \
      case 51221: { constexpr int NN = 512, PP = 2, DD = 1; __VA_ARGS__; }           \
      case 51231: { constexpr int NN = 512, PP = 3, DD = 1; __VA_ARGS__; }           \
      case 51223: { constexpr int NN = 512, PP = 2, DD = 3; __VA_ARGS__; }           \
      case 51233: { constexpr int NN = 512, PP = 3, DD = 3; __VA_ARGS__; }           \
      case 102421: { constexpr int NN = 1024, PP = 2, DD = 1; __VA_ARGS__; }         \
      case 102431: { constexpr int NN = 1024, PP = 3, DD = 1; __VA_ARGS__; }         \
      case 102423: { constexpr int NN = 1024, PP = 2, DD = 3; __VA_ARGS__; }         \
      case 102433: { constexpr int NN = 1024, PP = 3, DD = 3; __VA_ARGS__; }         \
      case 204821: { constexpr int NN = 2048, PP = 2, DD = 1; __VA_ARGS__; }         \
      case 204823: { constexpr int NN = 2048, PP = 2, DD = 3; __VA_ARGS__; }         \
      default: break;                                                           \
    }                                                                           \
  } while (0)

extern "C" {

// K1: y[M, N] = NTT (or inverse) of x[M, N] mod p; tab = this prime's uint2 [4][N].
int redsec_ntt(const int32_t* x, int32_t* y, const uint2* tab, int M, int N, int p, int inverse,
               cudaStream_t stream) {
  if (M <= 0 || p <= 2 || p >= (1 << 16)) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = [&](auto nn) {
    constexpr int NN = decltype(nn)::value;
    using Ge = Geo<NN>;
    const size_t bytes = sizeof(uint2) * NN + sizeof(uint32_t) * Ge::POLYS * 2 * Ge::XW;
    static redsec::PerDevice smem;
    if (!allow_smem(smem, ntt_kernel<NN>, bytes)) return static_cast<int>(cudaErrorInvalidValue);
    ntt_kernel<NN><<<(M + Ge::POLYS - 1) / Ge::POLYS, Ge::T, bytes, stream>>>(
        x, y, tab, static_cast<uint32_t>(p), inverse, M);
    return static_cast<int>(cudaGetLastError());
  };
  switch (N) {
    case 256: return run(std::integral_constant<int, 256>());
    case 512: return run(std::integral_constant<int, 512>());
    case 1024: return run(std::integral_constant<int, 1024>());
    case 2048: return run(std::integral_constant<int, 2048>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2: delta[M, 2, N] = digits[M, rows, N] (x) bk[P=2][rows][8][N] (prime
// stride prime_stride elements).
int redsec_external_product(const int32_t* digits, const int16_t* bk, long long prime_stride,
                            const uint2* tabs, int32_t* delta, int M, int N, int rows, int p0,
                            int p1, cudaStream_t stream) {
  const int pr[2] = {p0, p1};
  if (M <= 0 || rows <= 0 || !primes_ok(2, pr)) return static_cast<int>(cudaErrorInvalidValue);
  const Crt crt = make_crt(2, pr);
  REDSEC_DISPATCH_N(N, {
    const size_t bytes = Smem<NN, 1, 2, 1>::bytes(rows);
    static redsec::PerDevice smem;
    if (!allow_smem(smem, external_product_kernel<NN>, bytes))
      return static_cast<int>(cudaErrorInvalidValue);
    external_product_kernel<NN><<<M, Geo<NN>::T, bytes, stream>>>(digits, bk, prime_stride, tabs,
                                                                  delta, rows, crt);
  });
  return static_cast<int>(cudaGetLastError());
}

// K3: acc_out[M, 2, N] = acc + ExtProd(Decomp(X^t[m] acc - acc), bk round).
int redsec_cmux_round(const int32_t* acc, const int32_t* t, const int16_t* bk,
                      long long prime_stride, const uint2* tabs, int32_t* out, int M, int N,
                      int l, int bg_bit, uint32_t offset, int p0, int p1, cudaStream_t stream) {
  const int pr[2] = {p0, p1};
  if (M <= 0 || l <= 0 || bg_bit <= 0 || l * bg_bit > 32 || !primes_ok(2, pr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Crt crt = make_crt(2, pr);
  const Gadget g = make_gadget(l, bg_bit, offset, p1, N);
  REDSEC_DISPATCH_N(N, {
    const size_t bytes = Smem<NN, 1, 2, 1>::bytes(2 * l);
    static redsec::PerDevice smem;
    if (!allow_smem(smem, cmux_round_kernel<NN>, bytes))
      return static_cast<int>(cudaErrorInvalidValue);
    cmux_round_kernel<NN><<<M, Geo<NN>::T, bytes, stream>>>(acc, t, bk, prime_stride, tabs, out,
                                                            g, crt);
  });
  return static_cast<int>(cudaGetLastError());
}

// How K4 runs at batch B on a card with `sms` SMs: out[0] ciphertexts a
// block, out[1] digit rows a chunk, out[2] dynamic shared bytes, out[3] 1
// where every prime's stage tables stay in shared memory (0: one prime's at
// a time, each half refilled by cp.async with the next prime's), out[4] the
// shared bytes two ciphertexts a block would take with all their digit rows
// and every prime's tables (above what a block may have where they do not
// fit), out[5] 1 where the accumulators lie on r2 (Smem::ALIAS), out[6] 1
// where the last prime's MAC sums lie on the differences (Smem::ON_DIFF).
// Returns non-zero for a combination without an instance.
int redsec_blind_rotate_config(int B, int N, int l, int P, int bundle, int sms, int* out) {
  const int D = bundle == 2 ? 3 : 1;
  K4Config cf{0, 0, 0, false, false, false};
  size_t bytes2 = 0;
  bool ok = false;
  REDSEC_DISPATCH_K4(N, P, D, {
    ok = k4_config<NN, PP, DD>(B, DD * 2 * l, sms, &cf);
    bytes2 = smem_bytes<NN, 2, PP, DD>(Geo<NN>::RESIDENT ? PP : 1, DD * 2 * l, false, false);
    break;
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = cf.G;
  out[1] = cf.cr;
  out[2] = static_cast<int>(cf.bytes);
  out[3] = cf.resident;
  out[4] = static_cast<int>(bytes2);
  out[5] = cf.alias;
  out[6] = cf.on_diff;
  return 0;
}

// K4: all CMUX rounds; bk int16 [P][n][rows][8][N] (bundle 1) or
// [P][n/2][3 * rows][8][N] (bundle 2), abar int32 [B][n]; primes p0 < p1 (< p2).
int redsec_blind_rotate(const int32_t* acc0, const int32_t* abar, const int16_t* bk,
                        const uint2* tabs, int32_t* out, int B, int n, int N, int l, int bg_bit,
                        uint32_t offset, int P, int p0, int p1, int p2, int bundle,
                        cudaStream_t stream) {
  const int pr[3] = {p0, p1, p2};
  if (B <= 0 || n <= 0 || l <= 0 || bg_bit <= 0 || l * bg_bit > 32 || !primes_ok(P, pr) ||
      (bundle != 1 && bundle != 2) || (bundle == 2 && n % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Crt crt = make_crt(P, pr);
  const Gadget g = make_gadget(l, bg_bit, offset, pr[P - 1], N);
  const int D = bundle == 2 ? 3 : 1;
  int code = static_cast<int>(cudaErrorInvalidValue);
  REDSEC_DISPATCH_K4(N, P, D, code = dispatch_blind_rotate<NN, PP, DD>(acc0, abar, bk, tabs, out, B,
                                                                       n, g, crt, stream);
                     break);
  return code;
}

}  // extern "C"

// the library's Python module (py_entries.cuh)
REDSEC_PY_MODULE(pbs, REDSEC_PY_LAUNCH(redsec_ntt),
                 REDSEC_PY_LAUNCH(redsec_external_product),
                 REDSEC_PY_LAUNCH(redsec_cmux_round),
                 REDSEC_PY_FN(redsec_blind_rotate_config),
                 REDSEC_PY_LAUNCH(redsec_blind_rotate))
