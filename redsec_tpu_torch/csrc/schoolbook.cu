// The schoolbook external product (S1) for Hopper (sm_90a) on the int8
// tensor cores (wgmma), bound to PyTorch with ctypes
// (redsec_tpu_torch/crypto/kernels.py::schoolbook_product).
//
// It is one CMUX round's external product for the parameter sets without
// NTT primes (N >= 4096: medium, large, medium_v2, large_v2), and for any
// set when the NTT plan is switched off:
//
//   delta[b, u] = sum_r digits[b, r] * bk[r, u]   in Z[X]/(X^N + 1), mod 2^32
//
// digits int32 [B, rows, N] (signed gadget digits in [-half_bg, half_bg)),
// bk int32 [rows, 2, N] (one round of the raw bootstrapping key, shared by the
// whole batch), delta int32 [B, 2, N].
//
// What it replaces: no Pallas kernel.  The JAX package runs this product as
// one XLA int8 convolution a round (redsec_tpu/crypto/bootstrap.py:517-556,
// external_delta_schoolbook: 8-bit limbs of the key and of the digits
// correlated with int32 accumulation); its TPU probe of the product's
// Toeplitz tile was scripts/bench_schoolbook.py:254 (K7).  The output is the
// same exact negacyclic product, so it is bit-identical.
//
// The formulation (JAX's, in exact integers).  As a matrix product,
// delta[b, k] = sum_r sum_j D_r[b, j] ext_r(k - j), with ext(m) = bk[m] for
// m >= 0 and uint32(-bk[m + N]) for m < 0 (the negacyclic Toeplitz
// generator; the negation is taken in uint32, never on an int8 value).  Split
// ext into its four unsigned bytes e_l in [0, 255] and each digit into signed
// limbs: one s8 limb where half_bg <= 128; two where half_bg <= 512,
// lo = d mod 2^8 in [-128, 127] and hi = (d - lo) / 2^8 in [-2, 2].  Then
//
//   delta = sum_{dl + l < 4} 2^(8 (dl + l)) sum_r D_{r,dl} T(e_{r,l})  mod 2^32
//
// (pairs with dl + l >= 4 are multiples of 2^32).  Each inner sum is an
// s8 x u8 product with int32 accumulation: it runs on wgmma m64nNk32
// u8.s8 -> s32, without .satfinite.  The pairs of one shift s = dl + l share
// one accumulator, so a tap adds at most 128 * 255 (one limb) or
// (128 + 2) * 255 (two) to it, and a run of F digit rows at most
// c * 255 * F * N with c = 128 or 130.  The wrapper passes F as the largest
// run below 2^31 (kernels.py::schoolbook_flush_rows); every accumulator is
// added into the uint32 total (acc << 8 s, mod 2^32) and cleared after each
// run of F rows, so no int32 sum ever wraps.  For every set of
// crypto/params.py F >= rows: one flush.  The tightest is large_v2 (rows 8,
// N 8192, one limb): 128 * 255 * 8 * 8192 = 2,139,095,040 < 2^31.
//
// Bound on the H100: operations.  This formulation: 8 x rows x N^2 int8
// MACs a ciphertext (2 polynomials x 4 key limbs; x2 where the digits take
// two limbs) at 989.5e12 a second: 0.556 ms at [512, 8, 4096] (medium_v2).
// The function's cheapest known formulation is its twin's, exact float64
// FFTs of length 2N: about 2.2e9 flops at that shape, 0.065 ms at the
// card's 33.45e12 fp64 flops a second (chip_smoke.py::schoolbook_fft_flops);
// that is the smoke's bound_ms.  The earlier design did one uint32
// multiply-add a tap on the CUDA cores, whose IMAD pipe (132 SMs x 64 lanes
// x 1.98 GHz) floors that shape at 8.205 ms; it ran at 84% of that floor,
// with the tensor cores idle.  This one does 4x (one digit limb) or 7x (two)
// the MACs on a unit 59x faster.  mma.sync, Hopper's older tensor-core path,
// issues these MACs at 0.66 of the peak on an H100 at 700 W, wgmma at 0.97
// even 32 columns wide (tools/mma_rate.py), so S1 runs on wgmma.  This
// design reaches 46% of its own formulation's bound there, 5% of the FFT's.
//
// Design.  The output coefficients are the MMA's m dimension, the batch its
// n, the taps its k: out^T[k, b] = sum_j A[k, j] B[j, b] with A[k, j] =
// e_l(k - j) (u8) and B[j, b] = D[b, j] (s8).  A block computes TK = 16 MT
// coefficients x TB = 8 NT ciphertexts of both polynomials with two
// warpgroups, one a polynomial u.  The m64 rows of a wgmma are the four
// warps' 16 each, and warp s of a warpgroup holds key limb s: one wgmma
// m64nTBk32 computes 16 coefficients of all four limbs at once.  With two
// digit limbs a second wgmma multiplies key limb s - 1 (zero in warp 0)
// against the high limb.  The block walks the contraction (rows x N taps) in
// chunks of 256 taps:
// - Digits (B, shared memory): cp.async copies the int32 chunks [TB][256]
//   into a ring of about 64 KB (2 chunks at 32 ciphertexts a block, 8 at
//   8).  While the wgmmas of chunk q run, the threads pack chunk q + 1 into
//   s8 limbs, in wgmma's core matrices (8 ciphertexts x 16 taps, 128 bytes;
//   K-direction stride LBO 128 bytes, 8-ciphertext stride SBO 2048), so a
//   chunk costs one barrier.  A packed chunk feeds all 8 warps: 2
//   polynomials x 4 key limbs.
// - Key (A, registers): at each digit row the block writes, for each
//   (u, l), the bytes rev[y] = e_l(k0 + TK - 1 - y), y in [0, N + TK), of
//   ext in reverse order (N + TK bytes a limb; 66 KB for the 8 planes at
//   N = 8192).  The Toeplitz operand is never written anywhere: along a row
//   of A, taps j .. j + 3 read rev[y .. y + 3] for consecutive y, so each A
//   fragment register is one unaligned 4-byte read, two aligned words and a
//   funnel shift.  The four registers of a fragment lie at y - 8, y, y + 8,
//   y + 16.  This is why A is the Toeplitz side: wgmma takes A from
//   registers, and B only from shared memory, where the Toeplitz tile would
//   have to be written out every step.
// - Toeplitz reuse: the A fragment of m-tile i at taps jb equals that of
//   m-tile i + 2 at taps jb + 32, so each 32-tap step builds 2 new fragments
//   and shifts the other MT - 2 down by two: 12 shared loads and 8 shifts a
//   step for MT wgmmas.  The wgmmas of one step run while the next step's
//   fragments are built (wait_group 1); the fragments a step drops stay
//   pinned (live) until the wait that retires their wgmmas, so the compiler
//   gives their registers to nothing else.
// - A warp is held at its wgmma instructions while the tensor cores take
//   them, and work placed after them adds to the step's time rather than
//   hiding under it (tools/mma_rate.py's overlap probe).  So a step's
//   shared loads (the next fragments' 12 words, a part of the digits) are
//   issued before its wgmmas, and only the shifts and stores follow them.
// A thread's accumulator register 4 j + e holds row g + 8 (e / 2) of its
// warp's 16 (coefficient), column 8 j + 2 t + e % 2 (ciphertext) (g =
// lane / 4, t = lane % 4).  At a flush each warp adds acc << 8 s into a uint32
// total in shared memory (atomicAdd: exact and order-free mod 2^32); the
// block then writes the total out in 16-byte stores.  Tile shapes by batch:
// NT = 1, 2, 4 (8, 16, 32 ciphertexts) so a gate's 4 pad to 8; MT = 8, 4
// or 2 (128, 64, 32 coefficients), the largest that still gives the card a
// block per SM, so small batches split the coefficients finer.  Two digit
// limbs take NT <= 2 (registers).
//
// The extern "C" product entry returns cudaGetLastError() after its launch;
// the Python wrapper raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // 2 polynomials x 4 shifts
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 256;                // taps a staged digit chunk
constexpr int kSteps = kChunk / 32;        // k32 MMA steps a chunk
constexpr int kStageStride = kChunk + 16;  // int32 a staged ciphertext row (bank spread)
constexpr int kCoreBytes = 128;            // a wgmma core matrix: 8 rows x 16 bytes
constexpr int kGroupBytes = kChunk / 16 * kCoreBytes;  // 8 ciphertexts x the chunk's taps
constexpr int kPlanePad = 8;               // words past N + TK (the last step's reads)
constexpr int kPlaneWords = 4;             // plane words a thread loads at once

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// d += A (64 x 32 u8, registers: this warp's 16 rows) x B (32 x 8 NT s8,
// shared memory through ``desc``), s32 accumulation (wraps, no .satfinite;
// the flush keeps every sum inside int32).  d[4 j + e]: row g + 8 (e / 2)
// of this warp's 16, column 8 j + 2 t + e % 2.
__device__ __forceinline__ void wgmma(int (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.s8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma(int (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// A shared-memory matrix descriptor, no swizzle: 8-row x 16-byte core
// matrices, ``lbo`` bytes apart along K and ``sbo`` bytes apart along the
// rows (here the batch)
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// keeps the compiler from moving an accumulator between wgmma issue and wait
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The A fragment whose register 0 starts at byte 4 w + sh / 8 of a plane:
// registers at bytes y, y - 8, y + 16, y + 8 (rows g, g + 8; columns 4t and
// 16 + 4t of the m16n8k32 layout, which is each warp's 16 rows of wgmma's
// m64 A in registers), each bytes y .. y + 3 as one word.
__device__ __forceinline__ void build_fragment(uint32_t (&f)[4], const uint32_t* p, int w,
                                               int sh) {
  f[0] = __funnelshift_r(p[w], p[w + 1], sh);
  f[1] = __funnelshift_r(p[w - 2], p[w - 1], sh);
  f[2] = __funnelshift_r(p[w + 4], p[w + 5], sh);
  f[3] = __funnelshift_r(p[w + 2], p[w + 3], sh);
}

// The A fragments at words w and w - 4 from the 12 plane words w - 6 ..
// w + 5 (x[k] = word w - 6 + k)
__device__ __forceinline__ void fragments_from_words(uint32_t (&f0)[4], uint32_t (&f1)[4],
                                                     const uint32_t (&x)[12], int sh) {
  f0[0] = __funnelshift_r(x[6], x[7], sh);
  f0[1] = __funnelshift_r(x[4], x[5], sh);
  f0[2] = __funnelshift_r(x[10], x[11], sh);
  f0[3] = __funnelshift_r(x[8], x[9], sh);
  f1[0] = __funnelshift_r(x[2], x[3], sh);
  f1[1] = __funnelshift_r(x[0], x[1], sh);
  f1[2] = f0[0];
  f1[3] = f0[1];
}

template <int NT, int MT, int LIMBS>
struct Tile {
  static constexpr int TB = 8 * NT;   // ciphertexts a block
  static constexpr int TK = 16 * MT;  // output coefficients a block
  static constexpr int kTotStride = TK + 4;  // words; = 4 mod 32 spreads the flush over banks
  // int32 chunks in the ring (64 KB of them, at least 2): chunk q + 1 is
  // packed while chunk q is multiplied, and the loads run S - 1 chunks
  // ahead of the packing, so that a small tile, whose chunk takes little
  // compute, keeps enough of them in flight
  static constexpr int kStages =
      64 * 1024 / (TB * kChunk * 4) > 2 ? 64 * 1024 / (TB * kChunk * 4) : 2;
  static constexpr int kStageBytes = kStages * TB * kStageStride * 4;
  static constexpr int kTotBytes = 2 * TB * kTotStride * 4;
  static constexpr int kLimbBytes = NT * kGroupBytes;  // one s8 limb of a chunk
  static constexpr int kDigitBytes = 2 * LIMBS * kLimbBytes;
  __host__ __device__ static int plane_words(int N) { return (N + TK) / 4 + kPlanePad; }
  static size_t shared_bytes(int N) {
    return static_cast<size_t>(kStageBytes + kTotBytes + kDigitBytes) +
           static_cast<size_t>(8) * plane_words(N) * 4;
  }
};

// Block (kt, bt): coefficients [TK kt, TK kt + TK) of delta[b, 0..1] for
// ciphertexts [TB bt, TB bt + TB).  flush_rows: digit rows between flushes.
template <int NT, int MT, int LIMBS>
__global__ void __launch_bounds__(kThreads, 1)
schoolbook_mma_kernel(const int32_t* __restrict__ digits, const uint32_t* __restrict__ bk,
                      uint32_t* __restrict__ out, int B, int rows, int N, int flush_rows) {
  using T = Tile<NT, MT, LIMBS>;
  constexpr int TB = T::TB, TK = T::TK, S = T::kStages, R = TB / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  int32_t* stage = reinterpret_cast<int32_t*>(smem);  // [S][TB][kStageStride] int32
  uint32_t* tot = reinterpret_cast<uint32_t*>(smem + T::kStageBytes);  // [2][TB][kTotStride]
  // [2 buffers][LIMBS][NT groups of 8 ciphertexts][16 core columns][8][16] s8
  unsigned char* dig = smem + T::kStageBytes + T::kTotBytes;
  uint32_t* plane = reinterpret_cast<uint32_t*>(dig + T::kDigitBytes);  // [2 u][4 l][PW]
  const int PW = T::plane_words(N);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int u = warp >> 2, s = warp & 3;  // warpgroup u: polynomial; warp s: key limb
  const int k0 = blockIdx.x * TK, b0 = blockIdx.y * TB;
  const int chunks = N / kChunk, total = rows * chunks;

  for (int i = tid; i < 2 * TB * T::kTotStride; i += kThreads) tot[i] = 0u;

  // chunk q: digit row q / chunks, taps (q % chunks) * kChunk .. + 255;
  // ciphertexts past B read as zeros
  auto stage_chunk = [&](int q) {
    const int r = q / chunks, j0 = (q % chunks) * kChunk;
    int32_t* dst = stage + (q % S) * TB * kStageStride;
    for (int e = tid; e < TB * (kChunk / 4); e += kThreads) {
      const int b = e / (kChunk / 4), c = e % (kChunk / 4);
      const bool ok = b0 + b < B;
      const int32_t* src =
          digits + (static_cast<size_t>(ok ? b0 + b : 0) * rows + r) * N + j0 + 4 * c;
      cp_async16(dst + b * kStageStride + 4 * c, src, ok);
    }
    cp_async_commit();
  };

  // A fragment base of this lane: register 0 of m-tile i at taps jb starts
  // at byte y = TK - 1 - g + 4 t + jb - 16 i of the plane (row g, column
  // 4 t: ext(k0 + 16 i + g - jb - 4 t)); word w = y / 4, shift 8 (y % 4),
  // the same for every i and jb (both multiples of 4)
  const int ybase = TK - 1 - g + 4 * t;
  const int wb = ybase >> 2, sh = 8 * (ybase & 3);
  const uint32_t* pa = plane + (u * 4 + s) * PW;
  const uint32_t* pb = plane + (u * 4 + (s > 0 ? s - 1 : 0)) * PW;
  // the B operand of step st of buffer q & 1: core column 2 st onwards
  const uint64_t desc0 = smem_desc(dig, kCoreBytes, kGroupBytes);

  int acc[MT][R];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < R; ++e) acc[i][e] = 0;
  // fb: key limb s - 1 against the high digit limb; zero in warp 0 (wgmma
  // runs the warpgroup's four warps together)
  uint32_t fa[MT][4], fb[MT][4];
  auto build_all = [&](int wbase) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      build_fragment(fa[i], pa, wbase - 4 * i, sh);
      if (LIMBS == 2) {
        if (s > 0)
          build_fragment(fb[i], pb, wbase - 4 * i, sh);
        else
          fb[i][0] = fb[i][1] = fb[i][2] = fb[i][3] = 0u;
      }
    }
  };

  // pack part k of chunk q (items tid + 256 k): int32 digits -> s8 limbs,
  // four taps a word, into the core matrices of buffer q & 1: ciphertext b,
  // taps 4 cc .. 4 cc + 3 at (b / 8) kGroupBytes + (cc / 4) 128 + (b % 8) 16
  // + (cc % 4) 4 (a warp writes whole cores: no bank conflicts)
  constexpr int kPackParts = TB * (kChunk / 4) / kThreads;
  auto pack_item = [&](int k, int& b, int& cc) {
    const int e = tid + k * kThreads;
    cc = ((e >> 5) << 2 | (e & 3)) % (kChunk / 4);
    b = (e >> 2 & 7) | ((e >> 5) / (kChunk / 16)) << 3;
  };
  auto pack_load = [&](int q, int k) {
    int b, cc;
    pack_item(k, b, cc);
    return *reinterpret_cast<const int4*>(stage + (q % S) * TB * kStageStride +
                                          b * kStageStride + 4 * cc);
  };
  auto pack_store = [&](int q, int k, int4 v) {
    int b, cc;
    pack_item(k, b, cc);
    unsigned char* dst = dig + (q & 1) * LIMBS * T::kLimbBytes;
    const int off =
        (b >> 3) * kGroupBytes + (cc >> 2) * kCoreBytes + (b & 7) * 16 + (cc & 3) * 4;
    *reinterpret_cast<uint32_t*>(dst + off) = __byte_perm(
        __byte_perm(v.x, v.y, 0x0040), __byte_perm(v.z, v.w, 0x0040), 0x5410);
    if (LIMBS == 2) {
      // hi = (d - lo) >> 8 with lo the signed low byte
      const int h0 = (v.x - static_cast<int8_t>(v.x)) >> 8,
                h1 = (v.y - static_cast<int8_t>(v.y)) >> 8,
                h2 = (v.z - static_cast<int8_t>(v.z)) >> 8,
                h3 = (v.w - static_cast<int8_t>(v.w)) >> 8;
      *reinterpret_cast<uint32_t*>(dst + T::kLimbBytes + off) = __byte_perm(
          __byte_perm(h0, h1, 0x0040), __byte_perm(h2, h3, 0x0040), 0x5410);
    }
  };
  // the wgmma reads shared memory through the async proxy
  auto fence_proxy = [] { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); };

  // chunk p in cp.async group p; chunk 0 packed before the loop
  for (int p = 0; p < S; ++p) {
    if (p < total)
      stage_chunk(p);
    else
      cp_async_commit();  // an empty group keeps the count of pending groups
  }
  cp_async_wait<S - 1>();
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPackParts; ++k) pack_store(0, k, pack_load(0, k));
  fence_proxy();

  // fragments the wgmmas in flight still read: kept live (pinned) until the
  // wait that retires them, so the compiler cannot give their registers to
  // the fragments built meanwhile
  uint32_t da[2][4], db[2][4];
  auto pin = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        asm volatile("" ::"r"(da[j][e]));
        if (LIMBS == 2) asm volatile("" ::"r"(db[j][e]));
      }
  };
  int q = 0;
  for (int r = 0; r < rows; ++r) {
    if (r > 0) __syncthreads();  // every warp is done with row r - 1's planes
    // planes of row r: word w of (u, l) holds rev[4w .. 4w + 3] of byte l;
    // kPlaneWords words a thread in flight
    for (int e0 = tid; e0 < 2 * PW; e0 += kPlaneWords * kThreads) {
      uint32_t x[kPlaneWords][4];
#pragma unroll
      for (int v = 0; v < kPlaneWords; ++v) {
        const int e = e0 + v * kThreads;
        const int uu = e / PW, w = e % PW;
        const uint32_t* bkr = bk + (static_cast<size_t>(r) * 2 + uu) * N;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = k0 + TK - 1 - (4 * w + c);
          x[v][c] = e >= 2 * PW ? 0u
                    : m >= 0    ? bkr[m]
                    : m > -N    ? 0u - bkr[m + N]
                                : 0u;
        }
      }
#pragma unroll
      for (int v = 0; v < kPlaneWords; ++v) {
        const int e = e0 + v * kThreads;
        if (e >= 2 * PW) break;
        const int uu = e / PW, w = e % PW;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const uint32_t sel = l | ((l + 4) << 4);  // byte l of the first word, then the second
          const uint32_t lo2 = __byte_perm(x[v][0], x[v][1], sel),
                         hi2 = __byte_perm(x[v][2], x[v][3], sel);
          plane[(uu * 4 + l) * PW + w] = __byte_perm(lo2, hi2, 0x5410);
        }
      }
    }
    for (int c = 0; c < chunks; ++c, ++q) {
      // chunk q + 1 has landed (this thread's copies: groups up to q + S - 1
      // are committed); the barrier publishes it, chunk q's packed limbs and
      // the planes, and every warp has retired its wgmmas of chunk q - 1
      cp_async_wait<S - 2>();
      __syncthreads();
      if (q + S < total)
        stage_chunk(q + S);  // into chunk q's slot, packed before the barrier
      else
        cp_async_commit();
      const bool next = q + 1 < total;
      const uint64_t dlo = desc0 + (((q & 1) * LIMBS * T::kLimbBytes) >> 4);
      const uint64_t dhi = dlo + (T::kLimbBytes >> 4);
      const int jc = c * kChunk;  // taps of the row before this chunk
      if (c == 0) build_all(wb);
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        // step st: taps jc + 32 st .. + 31, core columns 2 st and 2 st + 1.
        // A warp waits at its wgmmas while the tensor cores take them, so the
        // step's shared loads go first and their latency is spent there: the
        // 12 plane words of the next step's two new fragments, and a part of
        // chunk q + 1's digits
        const int wn = wb + (jc + 32 * st + 32) / 4;
        uint32_t xa[12], xb[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          xa[k] = pa[wn - 6 + k];
          if (LIMBS == 2) xb[k] = s > 0 ? pb[wn - 6 + k] : 0u;
        }
        const bool pack = st < kPackParts && next;
        const int4 pv = pack ? pack_load(q + 1, st) : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int i = 0; i < MT; ++i) fence_operands(acc[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < MT; ++i) wgmma(acc[i], fa[i], dlo + st * (2 * kCoreBytes >> 4));
        if (LIMBS == 2) {
#pragma unroll
          for (int i = 0; i < MT; ++i) wgmma(acc[i], fb[i], dhi + st * (2 * kCoreBytes >> 4));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (pack) pack_store(q + 1, st, pv);
        // the previous step's wgmmas are retired: its dropped fragments may go
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (st > 0) pin();
        // advance to taps jb + 32: m-tile i takes m-tile i - 2's fragment;
        // tiles 0 and 1 are read anew (past the row's end they read the
        // plane's zero pad and are not used)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          da[0][e] = fa[MT - 2][e];
          da[1][e] = fa[MT - 1][e];
          if (LIMBS == 2) {
            db[0][e] = fb[MT - 2][e];
            db[1][e] = fb[MT - 1][e];
          }
        }
#pragma unroll
        for (int i = MT - 1; i >= 2; --i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            fa[i][e] = fa[i - 2][e];
            if (LIMBS == 2) fb[i][e] = fb[i - 2][e];
          }
        fragments_from_words(fa[0], fa[1], xa, sh);
        if (LIMBS == 2) fragments_from_words(fb[0], fb[1], xb, sh);
#pragma unroll
        for (int i = 0; i < MT; ++i) fence_operands(acc[i]);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin();
#pragma unroll
      for (int i = 0; i < MT; ++i) fence_operands(acc[i]);
      fence_proxy();  // chunk q + 1's packing, before the next barrier
    }
    if ((r + 1) % flush_rows == 0 || r + 1 == rows) {
      // acc[i][4 j + e]: row 16 i + g + 8 (e / 2), ciphertext 8 j + 2 t + e % 2
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < R; ++e) {
          const int kk = 16 * i + g + 8 * ((e & 3) >> 1), bb = 8 * (e >> 2) + 2 * t + (e & 1);
          atomicAdd(&tot[(u * TB + bb) * T::kTotStride + kk],
                    static_cast<uint32_t>(acc[i][e]) << (8 * s));
          acc[i][e] = 0;
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * TB * (TK / 4); e += kThreads) {
    const int uu = e / (TB * (TK / 4)), rem = e % (TB * (TK / 4));
    const int bb = rem / (TK / 4), c = rem % (TK / 4);
    if (b0 + bb < B) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(tot + (uu * TB + bb) * T::kTotStride + 4 * c);
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b0 + bb) * 2 + uu) * N + k0 +
                                4 * c) = v;
    }
  }
}

template <int NT, int MT, int LIMBS>
cudaError_t launch(const int32_t* digits, const uint32_t* bk, uint32_t* out, int B, int rows,
                   int N, int flush_rows, cudaStream_t stream) {
  using T = Tile<NT, MT, LIMBS>;
  const size_t bytes = T::shared_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(schoolbook_mma_kernel<NT, MT, LIMBS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(N / T::TK, (B + T::TB - 1) / T::TB);
  schoolbook_mma_kernel<NT, MT, LIMBS>
      <<<grid, kThreads, bytes, stream>>>(digits, bk, out, B, rows, N, flush_rows);
  return cudaGetLastError();
}

template <int LIMBS>
cudaError_t launch_nt_mt(int nt, int mt, const int32_t* d, const uint32_t* k, uint32_t* o, int B,
                         int rows, int N, int f, cudaStream_t st) {
  switch (nt * 16 + mt) {
    case 1 * 16 + 2: return launch<1, 2, LIMBS>(d, k, o, B, rows, N, f, st);
    case 1 * 16 + 4: return launch<1, 4, LIMBS>(d, k, o, B, rows, N, f, st);
    case 1 * 16 + 8: return launch<1, 8, LIMBS>(d, k, o, B, rows, N, f, st);
    case 2 * 16 + 2: return launch<2, 2, LIMBS>(d, k, o, B, rows, N, f, st);
    case 2 * 16 + 4: return launch<2, 4, LIMBS>(d, k, o, B, rows, N, f, st);
    case 2 * 16 + 8: return launch<2, 8, LIMBS>(d, k, o, B, rows, N, f, st);
    default: break;
  }
  if constexpr (LIMBS == 1) {
    switch (mt) {
      case 2: return launch<4, 2, 1>(d, k, o, B, rows, N, f, st);
      case 4: return launch<4, 4, 1>(d, k, o, B, rows, N, f, st);
      default: return launch<4, 8, 1>(d, k, o, B, rows, N, f, st);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* redsec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tile of a launch: out[0] = NT (8 NT ciphertexts a block), out[1] = MT
// (16 MT coefficients), out[2] = digit limbs.  NT: the fewest tiles of 8 that
// cover the batch, at most 4 (2 with two limbs); MT: the largest of 8, 4, 2
// (at most N / 16) whose grid still has a block for nearly every SM
// (sms - sms / 16), else 2.
int redsec_schoolbook_tile(int B, int N, int half_bg, int sms, int* out) {
  if (B <= 0 || N < kChunk || N % kChunk != 0 || half_bg < 1 || half_bg > 512 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int limbs = half_bg <= 128 ? 1 : 2;
  int nt = B <= 8 ? 1 : (B <= 16 ? 2 : 4);
  if (limbs == 2 && nt > 2) nt = 2;
  const long tiles_b = (B + 8L * nt - 1) / (8L * nt);
  int mt = 2;
  for (int m = 8; m > 2; m /= 2)
    if (16 * m <= N && (N / (16L * m)) * tiles_b >= sms - sms / 16) {
      mt = m;
      break;
    }
  out[0] = nt;
  out[1] = mt;
  out[2] = limbs;
  return 0;
}

// S1: delta[B, 2, N] = sum_r digits[B, r] * bk[r, u] (negacyclic, mod 2^32)
// for digits in [-half_bg, half_bg), half_bg <= 512.  N a multiple of 256
// (the wrapper passes 256 .. 8192), rows >= 1, flush_rows >= 1 digit rows
// whose sums stay inside int32 (see the note at the top), every pointer
// 16-byte aligned.
int redsec_schoolbook_product(const int32_t* digits, const int32_t* bk, int32_t* out, int B,
                              int rows, int N, int half_bg, int flush_rows, cudaStream_t stream) {
  int dev = 0, sms = 0, tile[3];
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || flush_rows <= 0 || N > 8192 ||
      redsec_schoolbook_tile(B, N, half_bg, sms, tile) != 0 || (B + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* k = reinterpret_cast<const uint32_t*>(bk);
  auto* o = reinterpret_cast<uint32_t*>(out);
  if (tile[2] == 1)
    return static_cast<int>(launch_nt_mt<1>(tile[0], tile[1], digits, k, o, B, rows, N,
                                            flush_rows, stream));
  return static_cast<int>(launch_nt_mt<2>(tile[0], tile[1], digits, k, o, B, rows, N,
                                          flush_rows, stream));
}

}  // extern "C"
