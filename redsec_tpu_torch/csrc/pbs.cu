// Blind-rotation kernels for Hopper (sm_90a): the programmable bootstrap's hot
// loop, bound to PyTorch with ctypes (redsec_tpu_torch/crypto/kernels.py).
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
// Design.  A block has N/2 threads and owns G ciphertexts (G = 2 when the
// batch exceeds the card's SM count, else 1; a ragged last block computes on
// a zero accumulator and stores nothing for the missing ciphertext).
//
// * Transforms run in registers.  N/16 threads share one polynomial, 16
//   coefficients a thread, so a block transforms 8 polynomials at once (the
//   digit rows of one prime, then the 8 accumulator polynomials, are
//   independent).  A transform is three register passes of 4 + 4 + log2(N/256)
//   radix-2 stages with two exchanges through shared memory between them:
//   two __syncthreads() a batch of 8 transforms, about 30 a CMUX round
//   (the first version had one barrier a stage and about 500 a round).
//   The exchange buffers are padded by N/256 words every N/16 so that all
//   three access patterns are free of bank conflicts, and there are two per
//   polynomial (first and second exchange) so that no barrier is needed
//   between reading one and writing the next.
// * Lazy arithmetic, p < 2^15.  Every twiddle w comes with w' = floor(w *
//   2^32 / p) (Shoup): x * w mod p = x*w - umulhi(x, w')*p lies in [0, 2p)
//   for ANY uint32 x.  Forward (decimation in frequency): the sum x + y is
//   not reduced, so a value entering stage s is below B0 * 2^s, where B0
//   bounds the twisted input; the difference x - y + B0 * 2^s is
//   non-negative and goes through the Shoup product; one Barrett reduction
//   to [0, p) ends the transform.  The twist is a Shoup product (B0 = 2p)
//   or, for gadget digits in [-Bg/2, Bg/2) with Bg * p * N < 2^32, the single
//   multiply-add d * psi^k + (Bg/2) * p (B0 = Bg * p).  Inverse (decimation
//   in time): t = y * w in [0, 2p), outputs x + t and x - t + 2p grow by 2p
//   a stage (< 24p after 10); the untwist's Shoup product and one
//   conditional subtraction end it in [0, p).  The first twiddle of every
//   stage is 1; the stages of the last register pass skip that product.
//   The MAC adds products of residues without reducing as long as they fit
//   a uint32 beside a carried value below 2p (all 12 rows at small_v2_tpu's
//   primes, at least four for any p < 2^15).
//   tests/test_torch_kernel_arith.py models exactly this arithmetic in numpy
//   and checks every bound.
// * Twiddles.  The stage tables of both primes and both directions (uint2 =
//   (w, w'), 32 KB at N = 1024) are staged in shared memory once a block;
//   twist and untwist (one coalesced load a coefficient) come through the
//   read-only cache.  Table layout per prime, uint2 [4][N]: twist, forward
//   stage tables (the stage of half-span h at offset N - 2h), untwist
//   (psi^-j / N), inverse stage tables (half-span h at offset h - 1); values
//   and order of ntt.NttPlan (kernels.shoup_tables builds it).
// * One key load serves G ciphertexts, and its latency stays out of the
//   loop: in the MAC a thread owns coefficients 2*tid and 2*tid + 1 of all
//   G.  The exchange buffers, idle then, hold a ring of four BK rows; each
//   thread copies the words it will itself read (cp.async, no barrier) three
//   rows ahead of the row it multiplies, reads each residue back with a
//   16-bit load (zero-extended for free) and uses it G times.
// * blind_rotate loops over all n rounds inside the block (the TPU's
//   sequential grid axis has no Hopper counterpart): the accumulators stay in
//   shared memory; each round writes X^t acc - acc + gadget offset once into
//   shared memory, and the forward transforms cut their digits out of it.
//
// Shared memory at N = 1024, rows = 12, G = 2 (dynamic, opted in with
// cudaFuncSetAttribute): stage tables 32 KB, exchange 68 KB, accumulators
// and rotated difference 32 KB, digit rows / MAC sums (uint16, aliased)
// 48 KB, prime-0 results 32 KB: 212 KB, one block of 16 warps per SM (124
// registers a thread).  G = 4 does not fit this layout.
//
// Bound on this card: int32 instructions.  The prepared BK is 137.6 MB at
// small_v2_tpu, 41 us at 3.35 TB/s, while 512 ciphertexts' rounds are
// ~2e11 modular operations (chip_smoke.py counts both); each operation is
// several instructions.  PERF.md has the instruction count read from the
// SASS (scripts/sass_count.py), the floor it gives at 64 int32 lanes an SM,
// and the measured times.
//
// Each extern "C" entry returns cudaGetLastError() after its launch; the
// Python wrapper raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPolys = 8;       // polynomials a block transforms at once
constexpr int kPer = 16;        // coefficients a thread holds
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

// Asynchronous 4-byte copy from global to shared memory (LDGSTS): the data
// goes past the registers, and the thread waits for it only where it needs
// it.  smem_addr is an address in the shared window (shared_address).
__device__ __forceinline__ void cp_async4(uint32_t smem_addr, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr), "l"(gmem)
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

// Geometry of one transform: L threads a polynomial, thread t of them holds
// 16 coefficients.  Pass A: positions t + L*k.  Pass B: L*b + j + S*k with
// t = b*S + j.  Pass C: four runs of four, 4*(t + L*g) + e.
template <int N>
struct Geo {
  static constexpr int T = N / 2;       // threads a block
  static constexpr int L = N / kPer;    // threads a polynomial (64 at N = 1024)
  static constexpr int S = L / kPer;    // 4, 2, 1 at N = 1024, 512, 256
  static constexpr int LOG_L = ilog2(L);
  static constexpr int LOG_S = ilog2(S);
  static constexpr int XW = N + kPer * S;  // words of one exchange buffer
  static_assert(T / L == kPolys, "a block transforms 8 polynomials at once");
  static_assert(S == 1 || S == 2 || S == 4, "N is 256, 512 or 1024");
  // exchange address of coefficient `pos`: S words of padding every L
  __device__ static __forceinline__ int addr(int pos) { return pos + ((pos >> LOG_L) << LOG_S); }
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
template <int N, class Load, class Store4>
__device__ __forceinline__ void ntt_fwd(const Load& load, const Store4& store4, bool active,
                                        const uint2* __restrict__ twist, const uint2* stage,
                                        uint32_t* x0, uint32_t* x1, Mod md, uint32_t B0) {
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
  if (active) {
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
    inv_stages<N>(v, stage, t, G::L, p);  // every value < 2p * (log2(N) + 2)
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int pos = t + G::L * k;
      store(pos, csub(shoup(v[k], __ldg(untwist + pos), p), p));
    }
  }
}

struct Crt {
  uint32_t p0, p1;
  uint2 inv01;  // p0^-1 mod p1 and its Shoup companion
  Mod m0, m1;
  // products of two residues that fit a uint32 beside a carried value below
  // 2p, per prime: floor((2^32 - 2p) / (p - 1)^2), at least 4 for p < 2^15
  int lazy0, lazy1;
};

// Signed CRT value of (c0 mod p0, c1 mod p1) as a torus32 (mod 2^32).  The
// external product is bounded by rows*N*(Bg/2)*128 < p0*p1/2.8
// (ntt.primes_for), so the exact sign decision agrees with the fp32 one of
// the JAX package on every reachable value.  v < p0*p1 < 2^30.
__device__ __forceinline__ uint32_t crt2(uint32_t c0, uint32_t c1, const Crt& c) {
  // Garner digit (c1 - c0) / p0 mod p1; c0 < p0 < p1 needs no reduction mod p1
  const uint32_t t1 = csub(shoup(c1 + c.p1 - c0, c.inv01, c.p1), c.p1);
  uint32_t v = c0 + t1 * c.p0;
  const uint32_t P = c.p0 * c.p1;
  if (2 * v >= P) v -= P;
  return v;
}

// Shared memory of the external product for G ciphertexts of `rows` digit
// rows; all offsets are multiples of 16 bytes.
template <int N, int G>
struct Smem {
  uint2* stage;     // [2 primes][2: forward, inverse][N]
  uint32_t* ex;     // [8 polynomials][2][XW] exchange buffers
  uint32_t* acc;    // [G][2][N] accumulators (unused by external_product)
  uint32_t* diff;   // [G][2][N] X^t acc - acc + gadget offset (likewise)
  uint16_t* r1;     // [G * max(rows, 8)][N]: digit rows in the NTT domain, then MAC sums
  uint16_t* r2;     // [G * 8][N]: prime 0's inverse transforms
  __host__ __device__ static size_t bytes(int rows) {
    const int r = rows > 8 ? rows : 8;
    return sizeof(uint2) * 4 * N + sizeof(uint32_t) * (kPolys * 2 * Geo<N>::XW + 2 * G * 2 * N) +
           sizeof(uint16_t) * (static_cast<size_t>(G) * r * N + G * 8 * N);
  }
  __device__ Smem(unsigned char* base, int rows) {
    const int r = rows > 8 ? rows : 8;
    stage = reinterpret_cast<uint2*>(base);
    ex = reinterpret_cast<uint32_t*>(stage + 4 * N);
    acc = ex + kPolys * 2 * Geo<N>::XW;
    diff = acc + G * 2 * N;
    r1 = reinterpret_cast<uint16_t*>(diff + G * 2 * N);
    r2 = r1 + static_cast<size_t>(G) * r * N;
  }
};

// Copy the stage tables of both primes into shared memory.  tabs: uint2
// [2][4][N] in global memory.  Ends with a barrier.
template <int N>
__device__ __forceinline__ void stage_tables(uint2* stage, const uint2* __restrict__ tabs) {
  for (int i = threadIdx.x; i < 4 * N; i += N / 2) {
    const int pi = i / (2 * N), dir = (i / N) & 1, k = i & (N - 1);
    stage[i] = tabs[(pi * 4 + 1 + 2 * dir) * N + k];
  }
  __syncthreads();
}

// TGSW external products of this block's G ciphertexts:
//   delta[g][u] = sum_rows digit_row (x) BK[row][u]  (mod 2^32, u = 0, 1)
// digit(g, j, pos) gives row j's signed digit of ciphertext g at coefficient
// pos, |digit| < p; digit.small_bias(p) is (Bg/2) * p where every digit lies
// in [-Bg/2, Bg/2) and Bg * p * N < 2^32, else 0.  bk points at the round
// slice of prime 0, int16 [rows][8][N] residues; prime 1's slice is
// prime_stride elements further.  On return delta[g][u][e] holds coefficient
// 2*tid + e.  The caller puts a barrier between its own shared-memory
// writes and this call; after its last barrier the function only reads r1
// and r2.
template <int N, int G, class DigitFn>
__device__ __forceinline__ void external_product_block(
    const DigitFn& digit, int rows, const int16_t* __restrict__ bk, long long prime_stride,
    const uint2* __restrict__ tabs, const Crt& crt, const Smem<N, G>& sm,
    uint32_t (&delta)[G][2][2]) {
  using Ge = Geo<N>;
  const int tid = threadIdx.x;
  const int grp = tid / Ge::L;
  uint32_t* x0 = sm.ex + grp * 2 * Ge::XW;
  uint32_t* x1 = x0 + Ge::XW;
  uint32_t* r1w = reinterpret_cast<uint32_t*>(sm.r1);  // packed pairs of residues
#pragma unroll 1
  for (int pi = 0; pi < 2; ++pi) {
    const Mod md = pi ? crt.m1 : crt.m0;
    const uint32_t p = md.p;
    const uint2* tab = tabs + pi * 4 * N;
    const uint2* stage = sm.stage + pi * 2 * N;

    // forward transforms of the G * rows digit polynomials, 8 at a time
#pragma unroll 1
    for (int q0 = 0; q0 < G * rows; q0 += kPolys) {
      const int q = q0 + grp;
      const int g = q / rows, j = q - g * rows;
      uint16_t* slot = sm.r1 + static_cast<size_t>(q) * N;
      const auto store = [&](int pos, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
        *reinterpret_cast<uint2*>(slot + pos) = make_uint2(a | (b << 16), c | (d << 16));
      };
      const uint32_t bias = digit.small_bias(p);
      if (bias != 0u) {
        // digits in [-Bg/2, Bg/2): d * psi^pos + (Bg/2) * p is in [0, Bg * p),
        // one multiply-add and no reduction
        ntt_fwd<N>(
            [&](int pos, uint2 tw) {
              return static_cast<uint32_t>(digit(g, j, pos)) * tw.x + bias;
            },
            store, q < G * rows, tab, stage, x0, x1, md, 2 * bias);
      } else {
        ntt_fwd<N>(
            [&](int pos, uint2 tw) {
              const int d = digit(g, j, pos);
              return shoup(static_cast<uint32_t>(d < 0 ? d + static_cast<int>(p) : d), tw, p);
            },
            store, q < G * rows, tab, stage, x0, x1, md, 2 * p);
      }
    }
    __syncthreads();

    // MAC over the rows: this thread's coefficients 2*tid and 2*tid + 1 of
    // all 8 outputs and G ciphertexts, each BK residue fetched once for all
    // G.  The exchange buffers are idle here and serve as a ring of four rows
    // of BK: a thread copies the words it will itself read (so no barrier),
    // asynchronously and three rows ahead of the row it multiplies, which
    // keeps the L2 latency out of the loop.  `lazy` products of residues fit
    // a uint32 beside a carried value < 2p, so the sums are reduced (to
    // [0, 2p)) only when the next four rows would not fit, and at the end.
    uint32_t a[G][8][2];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int o = 0; o < 8; ++o) a[g][o][0] = a[g][o][1] = 0u;
    const uint32_t* bkw = reinterpret_cast<const uint32_t*>(bk + pi * prime_stride) + tid;
    uint32_t* ring = sm.ex + tid;  // [4][8][N/2] words, a pair of residues each
    const uint16_t* ringh = reinterpret_cast<const uint16_t*>(ring);
    const uint32_t ring_addr = shared_address(ring);
    const auto fetch = [&](int row, int slot) {  // slot is a constant where this is called
      const uint32_t* src = bkw + row * 8 * (N / 2);
#pragma unroll
      for (int o = 0; o < 8; ++o)
        cp_async4(ring_addr + 4u * ((slot * 8 + o) * (N / 2)), src + o * (N / 2));
      cp_async_commit();
    };
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r < rows) fetch(r, r);
    const int lazy = pi ? crt.lazy1 : crt.lazy0;
    int pending = 0;
#pragma unroll 1
    for (int j0 = 0; j0 < rows; j0 += 4) {
      if (pending + 4 > lazy) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            a[g][o][0] = reduce_2p(a[g][o][0], md);
            a[g][o][1] = reduce_2p(a[g][o][1], md);
          }
        pending = 0;
      }
      pending += 4;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        if (j < rows) {
          // rows j .. min(j + 3, rows - 1) are in flight: row j must have landed
          if (j + 3 < rows)
            cp_async_wait<3>();
          else
            cp_async_wait<0>();
          uint32_t d[G][2];
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int e = 0; e < 2; ++e) d[g][e] = sm.r1[(g * rows + j) * N + 2 * tid + e];
#pragma unroll
          for (int o = 0; o < 8; ++o)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t w = ringh[(jj * 8 + o) * N + e];
#pragma unroll
              for (int g = 0; g < G; ++g) a[g][o][e] += d[g][e] * w;
            }
          // Refill the slot this thread has just read (nobody else touches
          // these words).  Read-then-asynchronous-write is safe: the "memory"
          // clobber of cp_async4 keeps the compiler from moving the copy
          // above the loads of `w`, the SM issues a thread's shared loads and
          // its cp.async through one in-order pipe, and a load has picked its
          // data up long before the copy's global read can come back to write.
          if (j + 4 < rows) fetch(j + 4, jj);
        }
      }
    }
    __syncthreads();  // every digit row has been read: r1 becomes the MAC sums
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int o = 0; o < 8; ++o)  // < 2p < 2^16 each
        r1w[(g * 8 + o) * (N / 2) + tid] =
            reduce_2p(a[g][o][0], md) | (reduce_2p(a[g][o][1], md) << 16);
    __syncthreads();

    // inverse transforms of the G * 8 sums; prime 0's go to r2, prime 1's
    // stay in place
#pragma unroll 1
    for (int q0 = 0; q0 < G * 8; q0 += kPolys) {
      const int q = q0 + grp;
      const uint16_t* src = sm.r1 + static_cast<size_t>(q) * N;
      uint16_t* dst = (pi ? sm.r1 : sm.r2) + static_cast<size_t>(q) * N;
      ntt_inv<N>(
          [&](int pos) {
            const uint2 w = *reinterpret_cast<const uint2*>(src + pos);
            return make_uint4(w.x & 0xffffu, w.x >> 16, w.y & 0xffffu, w.y >> 16);
          },
          [&](int pos, uint32_t v) { dst[pos] = static_cast<uint16_t>(v); },
          true, tab + 2 * N, stage + N, x0, x1, md);
    }
    __syncthreads();
  }
  // CRT and the recombination of the 4 BK limbs
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int u = 0; u < 2; ++u) delta[g][u][0] = delta[g][u][1] = 0u;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = (g * 8 + o) * N + 2 * tid + e;
        delta[g][o / 4][e] += crt2(sm.r2[k], sm.r1[k], crt) << (8 * (o % 4));
      }
    }
  }
}

struct Gadget {
  int l, bg_bit;
  uint32_t offset;  // sum_j (Bg/2) * 2^(32 - (j+1)*bg_bit), as uint32
  int small;        // Bg * p * N < 2^32 for both primes: the twist needs no reduction
};

Gadget make_gadget(int l, int bg_bit, uint32_t offset, int p0, int p1, int N) {
  const unsigned long long p = p0 > p1 ? p0 : p1;
  return Gadget{l, bg_bit, offset, ((p * N) << bg_bit) < 0x100000000ull};
}

// u = X^t acc - acc + gadget offset for the block's G ciphertexts, from the
// accumulators in shared memory into sm.diff: X^t acc [k] = +-acc[(k - t) mod
// N], negated when (k - t) mod 2N >= N.  t[c] in [0, 2N).  Ends with a barrier.
template <int N, int G>
__device__ __forceinline__ void rotate_diff(const Smem<N, G>& sm, const int (&t)[G],
                                            uint32_t offset) {
#pragma unroll
  for (int c = 0; c < G; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = threadIdx.x + e * (N / 2);
      int src = k - t[c];
      if (src < 0) src += 2 * N;
      const bool neg = src >= N;
      src = neg ? src - N : src;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t* a = sm.acc + (c * 2 + u) * N;
        sm.diff[(c * 2 + u) * N + k] = (neg ? 0u - a[src] : a[src]) - a[k] + offset;
      }
    }
  __syncthreads();
}

// Signed gadget digits of the values rotate_diff left in shared memory.
// Row j = bloc * l + level.
template <int N>
struct GadgetDigits {
  const uint32_t* u;  // [G][2][N]
  Gadget g;
  __device__ __forceinline__ int operator()(int ct, int j, int pos) const {
    const int bloc = j / g.l, lv = j - bloc * g.l;
    const int shift = 32 - (lv + 1) * g.bg_bit;
    const uint32_t f = (u[(ct * 2 + bloc) * N + pos] >> shift) & ((1u << g.bg_bit) - 1u);
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

// K1: 8 rows a block; rows beyond M are masked.
template <int N>
__global__ void __launch_bounds__(N / 2) ntt_kernel(const int32_t* __restrict__ x,
                                                    int32_t* __restrict__ y,
                                                    const uint2* __restrict__ tab, uint32_t p,
                                                    int inverse, int M) {
  using Ge = Geo<N>;
  extern __shared__ uint4 smem_raw[];
  uint2* stage = reinterpret_cast<uint2*>(smem_raw);
  uint32_t* ex = reinterpret_cast<uint32_t*>(stage + N);
  const int tid = threadIdx.x, grp = tid / Ge::L;
  const long long row = static_cast<long long>(blockIdx.x) * kPolys + grp;
  const bool active = row < M;
  for (int i = tid; i < N; i += N / 2) stage[i] = tab[(inverse ? 3 : 1) * N + i];
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
__global__ void __launch_bounds__(N / 2) external_product_kernel(
    const int32_t* __restrict__ digits, const int16_t* __restrict__ bk, long long prime_stride,
    const uint2* __restrict__ tabs, int32_t* __restrict__ delta_out, int rows, Crt crt) {
  extern __shared__ uint4 smem_raw[];
  const Smem<N, 1> sm(reinterpret_cast<unsigned char*>(smem_raw), rows);
  stage_tables<N>(sm.stage, tabs);
  const long long m = blockIdx.x;
  const RowDigits<N> dig{digits + m * rows * N};
  uint32_t delta[1][2][2];
  external_product_block<N, 1>(dig, rows, bk, prime_stride, tabs, crt, sm, delta);
#pragma unroll
  for (int u = 0; u < 2; ++u)
    *reinterpret_cast<int2*>(delta_out + (m * 2 + u) * N + 2 * threadIdx.x) =
        make_int2(delta[0][u][0], delta[0][u][1]);
}

template <int N>
__global__ void __launch_bounds__(N / 2) cmux_round_kernel(
    const int32_t* __restrict__ acc_in, const int32_t* __restrict__ t,
    const int16_t* __restrict__ bk, long long prime_stride, const uint2* __restrict__ tabs,
    int32_t* __restrict__ acc_out, Gadget g, Crt crt) {
  extern __shared__ uint4 smem_raw[];
  const int rows = 2 * g.l;
  const Smem<N, 1> sm(reinterpret_cast<unsigned char*>(smem_raw), rows);
  const long long m = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < 2 * N; k += N / 2) sm.acc[k] = static_cast<uint32_t>(acc_in[m * 2 * N + k]);
  stage_tables<N>(sm.stage, tabs);  // ends with a barrier
  const int tt[1] = {t[m]};
  rotate_diff<N, 1>(sm, tt, g.offset);
  const GadgetDigits<N> dig{sm.diff, g};
  uint32_t delta[1][2][2];
  external_product_block<N, 1>(dig, rows, bk, prime_stride, tabs, crt, sm, delta);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int k = u * N + 2 * tid;
    *reinterpret_cast<int2*>(acc_out + m * 2 * N + k) =
        make_int2(sm.acc[k] + delta[0][u][0], sm.acc[k + 1] + delta[0][u][1]);
  }
}

// K4: block b owns ciphertexts b*G .. b*G + G - 1; those beyond B run on a
// zero accumulator and are not stored.
template <int N, int G>
__global__ void __launch_bounds__(N / 2, 1) blind_rotate_kernel(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ abar,
    const int16_t* __restrict__ bk, const uint2* __restrict__ tabs,
    int32_t* __restrict__ acc_out, int B, int n, Gadget g, Crt crt) {
  extern __shared__ uint4 smem_raw[];
  const int rows = 2 * g.l;
  const Smem<N, G> sm(reinterpret_cast<unsigned char*>(smem_raw), rows);
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * G;
  const long long round_stride = static_cast<long long>(rows) * 8 * N;
  const long long prime_stride = round_stride * n;
#pragma unroll
  for (int c = 0; c < G; ++c)
    for (int k = tid; k < 2 * N; k += N / 2)
      sm.acc[c * 2 * N + k] =
          first + c < B ? static_cast<uint32_t>(acc0[(first + c) * 2 * N + k]) : 0u;
  stage_tables<N>(sm.stage, tabs);  // ends with a barrier
  const GadgetDigits<N> dig{sm.diff, g};
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    int tt[G];
#pragma unroll
    for (int c = 0; c < G; ++c) tt[c] = first + c < B ? abar[(first + c) * n + j] : 0;
    rotate_diff<N, G>(sm, tt, g.offset);
    uint32_t delta[G][2][2];
    // reads sm.diff, never sm.acc, and only r1 and r2 after its last barrier
    external_product_block<N, G>(dig, rows, bk + j * round_stride, prime_stride, tabs, crt, sm,
                                 delta);
#pragma unroll
    for (int c = 0; c < G; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint2* a = reinterpret_cast<uint2*>(sm.acc + (c * 2 + u) * N + 2 * tid);
        const uint2 v = *a;
        *a = make_uint2(v.x + delta[c][u][0], v.y + delta[c][u][1]);
      }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < G; ++c)
    if (first + c < B)
      for (int k = tid; k < 2 * N; k += N / 2)
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

Crt make_crt(int p0, int p1) {
  Crt c;
  c.p0 = static_cast<uint32_t>(p0);
  c.p1 = static_cast<uint32_t>(p1);
  c.inv01.x = powmod(c.p0 % c.p1, c.p1 - 2, c.p1);
  c.inv01.y = static_cast<uint32_t>((static_cast<unsigned long long>(c.inv01.x) << 32) / c.p1);
  c.m0 = make_mod(c.p0);
  c.m1 = make_mod(c.p1);
  c.lazy0 = static_cast<int>((0x100000000ull - 2 * c.p0) / ((c.p0 - 1ull) * (c.p0 - 1ull)));
  c.lazy1 = static_cast<int>((0x100000000ull - 2 * c.p1) / ((c.p1 - 1ull) * (c.p1 - 1ull)));
  return c;
}

bool primes_ok(int p0, int p1) {
  return p0 > 2 && p0 < p1 && p1 < (1 << 15);  // ascending, as ntt.primes_for gives them
}

// SMs of the current device (the launch's stream belongs to it).
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// Opt the kernel in to `bytes` of dynamic shared memory; false if the card
// does not give a block that much.
template <class Kernel>
bool allow_smem(Kernel kernel, size_t bytes) {
  return bytes <= kMaxSmem &&
         cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes)) == cudaSuccess;
}

// Ciphertexts a block of blind_rotate owns: 2 when one ciphertext a block
// would need more than one wave of blocks and two fit shared memory.
template <int N>
int blind_rotate_group(int B, int rows) {
  return B > sm_count() && Smem<N, 2>::bytes(rows) <= kMaxSmem ? 2 : 1;
}

template <int N, int G>
int launch_blind_rotate(const int32_t* acc0, const int32_t* abar, const int16_t* bk,
                        const uint2* tabs, int32_t* out, int B, int n, Gadget g, Crt crt,
                        cudaStream_t stream) {
  const size_t bytes = Smem<N, G>::bytes(2 * g.l);
  if (!allow_smem(blind_rotate_kernel<N, G>, bytes)) return static_cast<int>(cudaErrorInvalidValue);
  blind_rotate_kernel<N, G><<<(B + G - 1) / G, N / 2, bytes, stream>>>(acc0, abar, bk, tabs, out,
                                                                      B, n, g, crt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REDSEC_DISPATCH_N(N_, ...)                             \
  switch (N_) {                                                 \
    case 256: { constexpr int NN = 256; __VA_ARGS__; break; }   \
    case 512: { constexpr int NN = 512; __VA_ARGS__; break; }   \
    case 1024: { constexpr int NN = 1024; __VA_ARGS__; break; } \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

extern "C" {

const char* redsec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1: y[M, N] = NTT (or inverse) of x[M, N] mod p; tab = this prime's uint2 [4][N].
int redsec_ntt(const int32_t* x, int32_t* y, const uint2* tab, int M, int N, int p, int inverse,
               cudaStream_t stream) {
  if (M <= 0 || p <= 2 || p >= (1 << 15)) return static_cast<int>(cudaErrorInvalidValue);
  REDSEC_DISPATCH_N(N, {
    const size_t bytes = sizeof(uint2) * NN + sizeof(uint32_t) * kPolys * 2 * Geo<NN>::XW;
    if (!allow_smem(ntt_kernel<NN>, bytes)) return static_cast<int>(cudaErrorInvalidValue);
    ntt_kernel<NN><<<(M + kPolys - 1) / kPolys, NN / 2, bytes, stream>>>(
        x, y, tab, static_cast<uint32_t>(p), inverse, M);
  });
  return static_cast<int>(cudaGetLastError());
}

// K2: delta[M, 2, N] = digits[M, rows, N] (x) bk[P=2][rows][8][N] (prime
// stride prime_stride elements).
int redsec_external_product(const int32_t* digits, const int16_t* bk, long long prime_stride,
                            const uint2* tabs, int32_t* delta, int M, int N, int rows, int p0,
                            int p1, cudaStream_t stream) {
  if (M <= 0 || rows <= 0 || !primes_ok(p0, p1)) return static_cast<int>(cudaErrorInvalidValue);
  const Crt crt = make_crt(p0, p1);
  REDSEC_DISPATCH_N(N, {
    const size_t bytes = Smem<NN, 1>::bytes(rows);
    if (!allow_smem(external_product_kernel<NN>, bytes))
      return static_cast<int>(cudaErrorInvalidValue);
    external_product_kernel<NN><<<M, NN / 2, bytes, stream>>>(digits, bk, prime_stride, tabs,
                                                              delta, rows, crt);
  });
  return static_cast<int>(cudaGetLastError());
}

// K3: acc_out[M, 2, N] = acc + ExtProd(Decomp(X^t[m] acc - acc), bk round).
int redsec_cmux_round(const int32_t* acc, const int32_t* t, const int16_t* bk,
                      long long prime_stride, const uint2* tabs, int32_t* out, int M, int N,
                      int l, int bg_bit, uint32_t offset, int p0, int p1, cudaStream_t stream) {
  if (M <= 0 || l <= 0 || bg_bit <= 0 || l * bg_bit > 32 || !primes_ok(p0, p1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Crt crt = make_crt(p0, p1);
  const Gadget g = make_gadget(l, bg_bit, offset, p0, p1, N);
  REDSEC_DISPATCH_N(N, {
    const size_t bytes = Smem<NN, 1>::bytes(2 * l);
    if (!allow_smem(cmux_round_kernel<NN>, bytes)) return static_cast<int>(cudaErrorInvalidValue);
    cmux_round_kernel<NN><<<M, NN / 2, bytes, stream>>>(acc, t, bk, prime_stride, tabs, out, g,
                                                        crt);
  });
  return static_cast<int>(cudaGetLastError());
}

// Ciphertexts a block of K4 owns at batch B (what redsec_blind_rotate
// chooses), or 0 for an N the kernels are not built for.
int redsec_blind_rotate_group(int B, int N, int l) {
  switch (N) {
    case 256: return blind_rotate_group<256>(B, 2 * l);
    case 512: return blind_rotate_group<512>(B, 2 * l);
    case 1024: return blind_rotate_group<1024>(B, 2 * l);
    default: return 0;
  }
}

// Dynamic shared memory, in bytes, of a K4 block that owns G ciphertexts.
int redsec_blind_rotate_shared_bytes(int N, int l, int G) {
  REDSEC_DISPATCH_N(N, return static_cast<int>(G == 2 ? Smem<NN, 2>::bytes(2 * l)
                                                      : Smem<NN, 1>::bytes(2 * l)));
  return 0;
}

// K4: all n CMUX rounds; bk int16 [2][n][rows][8][N], abar int32 [B][n].
int redsec_blind_rotate(const int32_t* acc0, const int32_t* abar, const int16_t* bk,
                        const uint2* tabs, int32_t* out, int B, int n, int N, int l, int bg_bit,
                        uint32_t offset, int p0, int p1, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || l <= 0 || bg_bit <= 0 || l * bg_bit > 32 || !primes_ok(p0, p1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Crt crt = make_crt(p0, p1);
  const Gadget g = make_gadget(l, bg_bit, offset, p0, p1, N);
  REDSEC_DISPATCH_N(N, return blind_rotate_group<NN>(B, 2 * l) == 2
                                  ? launch_blind_rotate<NN, 2>(acc0, abar, bk, tabs, out, B, n, g,
                                                               crt, stream)
                                  : launch_blind_rotate<NN, 1>(acc0, abar, bk, tabs, out, B, n, g,
                                                               crt, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
