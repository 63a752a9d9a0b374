// Four-step ("matmul") blind-rotation kernels for Hopper (sm_90a), a Python
// module of C entries (py_entries.cuh) under redsec_tpu_torch/crypto/kernels.py's
// "_mm" wrappers.
//
// The JAX package's Pallas round and blind-rotation kernels read the BK in
// the four-step [k1, k2] order of crypto/ntt_matmul.py (its REDSEC_NTT=matmul
// keys).  Three thin __global__ entries over one set of device functions
// compute what they compute, on that key order (outputs bit-identical):
//
//   external_product_mm_kernel  <- redsec_tpu/crypto/pallas_round.py::make_round_kernel
//   cmux_round_mm_kernel        <- redsec_tpu/crypto/pallas_round.py::make_full_round_kernel
//   blind_rotate_mm_kernel      <- redsec_tpu/crypto/pallas_blind.py::make_blind_rotate_kernel
//
// The two one-round kernels come in two designs, chosen by the wrapper from
// the batch and the card's occupancy (kernels.round_mm_split): <N>, one
// ciphertext a block as in K4-mm, for batches that fill the card; and the
// pair kernels (split_round), a ciphertext's round on a cluster of two
// blocks, one a prime, for batches that would leave SMs idle: a round alone
// on one SM is latency, not throughput.
//
// This is a library of its own (csrc/pbs.cu keeps the radix-2 kernels, their
// layout and registers).  Instances: the JAX kernels' own envelope
// (pallas_blind.supported, bundle 1): two primes below 2^15, N = R * 128 with
// R = 2, 4 or 8 (the parameter sets give N = 256 and 1024), digit rows set at
// run time (10, 12, 20 in the sets; at most kernels.k4mm_layout's limit).
//
// The transform (N = R * C, C = 128; a polynomial is an [R, C] matrix, j =
// j1 * C + j2, NTT index k1 * C + k2):
//   forward  z[k1, k2] = sum_j2 WC[j2, k2] TWf[k1, j2] A_j2[k1],
//            A_j2[k1]  = sum_j1 x[j1, j2] psi_R^(j1 (2 k1 + 1))
//   inverse  x[j1, j2] = sum_k1 psi_R^(-j1 (2 k1 + 1)) TWi[k1, j2] b[k1, j2],
//            b[k1, j2] = sum_c y[k1, -c mod C] WC[c, j2]
// with psi_R = psi^C a primitive 2R-th root.  The pre-twist psi^(j1 C) and
// the R-point DFT of the JAX formulation are one negacyclic R-point NTT
// (radix-2 butterflies, log2 R stages, in place of JAX's R^2 products); the
// rest of the twist, psi^j2, is folded into the twiddle (TWf = TW psi^j2),
// and the untwist psi^-j2 / N into the inverse twiddle (TWi = TWi_JAX
// psi^-j2 / N).  WCi[k2, j2] = WC[-k2 mod C, j2], so the inverse C-step
// multiplies by WC too, with its input columns reversed where it is written
// (one table a prime, not two).  ntt_matmul.kernel_tables_mm builds the tables;
// tests/test_torch_blind_mm.py models this arithmetic in numpy and holds it
// against the JAX package's ntt_device_mm / intt_device_mm element for
// element.
//
// * The 128-point C-steps run on the int8 tensor cores: mma.sync
//   m16n8k32 u8.u8 -> s32.  A value below 2^16 is two u8 limbs (lo = v & 255,
//   hi = v >> 8; WC's hi limb is 7 bits), and the product is three
//   accumulators: lo*lo, lo*hi + hi*lo (the two issued into the same
//   registers), hi*hi, each a sum of 128 products of at most 255 * 255, so at
//   most 2 * 128 * 255^2 = 16.6e6 < 2^31: exact.  v = P00 + (Pmid * 2^8 mod p)
//   + (P11 * 2^16 mod p) by two Shoup products (any uint32 in, [0, 2p) out)
//   is below 8.4e6 + 4p < 2^24, and one Barrett reduction leaves [0, p).
//   Each warp takes a 16-row tile of A (both limbs, 4 k-steps, in registers)
//   against four 8-column tiles of WC; rows of the u8 matrices are padded to
//   144 B (36 words: the 8 rows of a fragment load fall on 8 distinct groups
//   of 4 banks) and rows of 16-bit results to 136 halves.
// * The R-step, the twiddles, the MAC against the key's int16 rows and the
//   CRT run on the CUDA cores with pbs.cu's lazy Shoup arithmetic: the
//   forward R-NTT (Cooley-Tukey, bit-reversed out) takes digits mod p and
//   grows by 2p a stage (below 7p at R = 8); the twiddle's Shoup product and
//   one conditional subtraction leave [0, p), which the limb split needs
//   below 2^15.  The inverse (Gentleman-Sande, bit-reversed in) takes the
//   twiddled values below 2p and doubles a stage (below 2R p); one Barrett
//   reduction ends it.  The MAC adds products of residues without reducing
//   while they fit a uint32 beside a carried value below 2p (28 products at
//   12289, 12 at 18433).
// * One ciphertext a block (N/2 threads), all rounds in one launch with the
//   accumulator in shared memory, as K4.  The BK streams from L2 as one
//   sequence of key rows (round, prime, row: 8 x N int16 each, contiguous in
//   the prepared BK and in the word order the MAC reads) through a ring of
//   its own (KeyStream): each warp copies, 16 bytes a cp.async, the words
//   its own threads read, `depth` rows ahead, and meets only at __syncwarp
//   around them.  So the stream never stops at a block barrier: the first
//   rows of the next prime and round land while the inverse transforms, the
//   CRT and the next forward transforms run, and the MAC finds them there.
//   (A ring filled by one thread with one cp.async.bulk a row under full
//   and empty mbarriers was 4-10% slower: its refills wait for the slowest
//   warp at every row.)  Where a dedicated ring of kRingMin rows does not
//   fit beside the rest (17 or more digit rows at N = 1024), the ring lies
//   on U, idle during the MAC, and streams only inside it (kRingAliased
//   rows).
//
// Shared memory (dynamic; kernels.k4mm_layout mirrors SmemMM):
//   WC limbs of both primes [2][2][128][144] u8 = 73,728 B (staged once a block)
//   accumulators and differences [2][2][N] u32
//   U: the u8 limbs of the C-steps' left operand [2][Mr][144] (Mr = the
//      larger of rows * R and 8R, rounded up to 16); with the ring on it, the
//      larger of that and the ring [kRingAliased][8][N] u16
//   Z: 16-bit C-step results [Mr][136] (digits in the NTT domain, then the
//      inverse C-step's output)
//   r1, r2: the inverse transforms of primes 1 and 0, [8][N] u16 each
//   the ring [depth][8][N] u16, where it has its own region
//   small_v2_tpu (N 1024, 12 rows, 3 rows of ring):
//     73,728 + 16,384 + 27,648 + 26,112 + 32,768 + 49,152 = 225,792 B
//   plain small_v2_tpu2 (10 rows, 3 rows): 216,832 B
//   small_v2 (20 rows, 2 rows on U): 73,728 + 16,384 + 46,080 + 43,520 +
//     32,768 = 212,480 B
// A pair block (split_smem_bytes): WC of one prime 36,864 B, accumulators
// and differences, U and Z at Mr = rows x R (at least 8R), residues
// (split_res_bytes) and a ring of its own of up to 4 rows:
//   small_v2_tpu: 36,864 + 16,384 + 27,648 + 26,112 + 16,384 + 65,536
//     = 188,928 B; small_v2: 224,768 B
//
// Bound on this card: per round and ciphertext at small_v2_tpu the C-steps
// are (96 + 64) rows x 2 primes x 128 x 128 x 4 limb products = 21.0e6 int8
// MACs, 3.8 ms a 512-batch at the int8 peak; the rest is int32 work on the
// CUDA cores and key rows from L2 into the ring (70 GB a 512-batch at one
// ciphertext a block).  PERF.md has the measured times and the int32 floor
// read from the SASS (scripts/sass_count.py).
//
// Each extern "C" entry returns cudaGetLastError() after its launch; the
// Python wrapper raises if it is not 0.

#include <cooperative_groups.h>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch_once.cuh"
#include "py_entries.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kC = 128;           // columns of the four-step split
constexpr int kWS = kC + 16;      // bytes of a padded row of a u8 limb matrix
constexpr int kZS = kC + 8;       // halves of a padded row of 16-bit results
constexpr int kRingMax = 4;       // key rows a dedicated ring holds at most
constexpr int kRingMin = 2;       // fewest rows a dedicated ring is given; else it lies on U
constexpr int kRingAliased = 2;   // key rows of the ring on U
constexpr int kPrimes = 2;

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

// x mod p in [0, 2p) for any uint32 x.
__device__ __forceinline__ uint32_t reduce_2p(uint32_t x, Mod md) {
  return x - __umulhi(x, md.m) * md.p;
}
__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t p) { return x >= p ? x - p : x; }
// x mod p in [0, p) for any uint32 x.
__device__ __forceinline__ uint32_t reduce(uint32_t x, Mod md) {
  return csub(reduce_2p(x, md), md.p);
}
// x * w mod p in [0, 2p) for any uint32 x; tw = (w, floor(w * 2^32 / p)).
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint2 tw, uint32_t p) {
  return x * tw.x - __umulhi(x, tw.y) * p;
}

__device__ __forceinline__ uint32_t shared_address(const void* smem) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(smem));
}

__device__ __forceinline__ void cp_async16(uint32_t smem_addr, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}

// d += a (16 x 32 u8, row) * b (32 x 8 u8, col), s32 accumulators.
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Geometry: N = R * 128, N/2 threads a block; outside the transforms a
// thread owns E = 2 consecutive coefficients.
template <int N>
struct GeoMM {
  static constexpr int R = N / kC;
  static constexpr int LOG_R = ilog2(R);
  static constexpr int T = N / 2;
  static constexpr int WARPS = T / 32;
  static constexpr int E = 2;
  static_assert(R == 2 || R == 8, "N is 256 or 1024");
};

// Bit reversal of k over b <= 3 bits, without a loop (so that it folds to a
// constant at every unrolled use).
__host__ __device__ constexpr int brv(int k, int b) {
  return b <= 1 ? k : b == 2 ? ((k & 1) << 1) | (k >> 1) : ((k & 1) << 2) | (k & 2) | (k >> 2);
}

// Rows of the C-steps' left operand and of their results: the forward's
// rows * R or the inverse's 8R, whichever is more, rounded up to a whole
// m16 tile.
__host__ __device__ constexpr int mm_mrows(int R, int rows) {
  return ((rows * R > 8 * R ? rows * R : 8 * R) + 15) / 16 * 16;
}

// The layout, once (kernels.k4mm_layout mirrors it).  Offsets are multiples
// of 16 bytes.
__host__ __device__ constexpr size_t mm_wc_bytes() { return size_t(kPrimes) * 2 * kC * kWS; }
__host__ __device__ constexpr size_t mm_row_bytes(int N) { return size_t(8) * N * 2; }
__host__ __device__ constexpr size_t mm_ops_bytes(int N, int rows) {
  return size_t(2) * mm_mrows(N / kC, rows) * kWS;
}
// Everything but the ring, with U the operands alone.
__host__ __device__ constexpr size_t mm_base_bytes(int N, int rows) {
  return mm_wc_bytes() + size_t(4) * 2 * 2 * N + mm_ops_bytes(N, rows) +
         size_t(2) * mm_mrows(N / kC, rows) * kZS + size_t(2) * 2 * 8 * N;
}
// Rows of a dedicated ring: the most, up to kRingMax and the digit rows
// (so a refill crosses into the next prime at most), that fit beside the
// rest; 0 if fewer than kRingMin (or the digit rows) do.
__host__ __device__ constexpr int mm_ring_own(int N, int rows) {
  const int least = rows < kRingMin ? rows : kRingMin;
  int d = rows < kRingMax ? rows : kRingMax;
  while (d >= least && mm_base_bytes(N, rows) + d * mm_row_bytes(N) > kMaxSmem) --d;
  return d >= least ? d : 0;
}
__host__ __device__ constexpr bool mm_ring_aliased(int N, int rows) {
  return mm_ring_own(N, rows) == 0;
}
__host__ __device__ constexpr int mm_ring_rows(int N, int rows) {
  return mm_ring_aliased(N, rows) ? kRingAliased : mm_ring_own(N, rows);
}
__host__ __device__ constexpr size_t mm_u_bytes(int N, int rows) {
  return mm_ring_aliased(N, rows) && kRingAliased * mm_row_bytes(N) > mm_ops_bytes(N, rows)
             ? kRingAliased * mm_row_bytes(N)
             : mm_ops_bytes(N, rows);
}
__host__ __device__ constexpr size_t mm_smem_bytes(int N, int rows) {
  return mm_base_bytes(N, rows) - mm_ops_bytes(N, rows) + mm_u_bytes(N, rows) +
         (mm_ring_aliased(N, rows) ? 0 : mm_ring_rows(N, rows) * mm_row_bytes(N));
}

// The pair round kernels' block (K2-mm and K3-mm, split_round below; the
// wrapper's mirror is kernels.round_mm_layout): one prime, WC's limbs of
// that prime alone, and a ring of its own of up to kSplitRingMax rows (at
// least one).
constexpr int kSplitRingMax = 4;
// Rows of the C-steps' operands and results: the rows digit rows times R,
// or the 8R inverse rows, whichever is more, rounded up to a whole m16 tile.
__host__ __device__ constexpr int split_mrows(int R, int rows) {
  return ((rows * R > 8 * R ? rows * R : 8 * R) + 15) / 16 * 16;
}
// The residues' region: the block's own half of its outputs' coefficients
// and the CRT partner's residues of that half, [8][N / 2] u16 each.
__host__ __device__ constexpr size_t split_res_bytes(int N) { return size_t(16) * N; }
__host__ __device__ constexpr size_t split_base_bytes(int N, int rows) {
  return size_t(2) * kC * kWS + size_t(4) * 2 * 2 * N +
         size_t(2) * split_mrows(N / kC, rows) * kWS +
         size_t(2) * split_mrows(N / kC, rows) * kZS + split_res_bytes(N);
}
__host__ __device__ constexpr int split_ring_rows(int N, int rows) {
  int d = rows < kSplitRingMax ? rows : kSplitRingMax;
  while (d >= 1 && split_base_bytes(N, rows) + d * mm_row_bytes(N) > kMaxSmem) --d;
  return d;
}
__host__ __device__ constexpr size_t split_smem_bytes(int N, int rows) {
  return split_base_bytes(N, rows) + split_ring_rows(N, rows) * mm_row_bytes(N);
}
// The tag of SmemMM's pair-block layout.
struct PairBlock {};

template <int N>
struct SmemMM {
  uint8_t* wc;      // [prime][limb][128][kWS]: WC's lo and hi bytes
  uint32_t* acc;    // [2][N] (K3, K4)
  uint32_t* diff;   // [2][N] X^t acc - acc + gadget offset
  uint8_t* ulo;     // [Mr][kWS] lo limbs of the C-steps' left operand
  uint8_t* uhi;     // [Mr][kWS] hi limbs
  uint16_t* z;      // [Mr][kZS] C-step results
  uint16_t* r1;     // [8][N] inverse transforms of prime 1
  uint16_t* r2;     // [8][N] inverse transforms of prime 0
  uint32_t* ring;   // [depth][8][N/2] words of key residues (on ulo/uhi if aliased)
  __device__ SmemMM(unsigned char* base, int rows) {
    constexpr int R = GeoMM<N>::R;
    const bool aliased = mm_ring_aliased(N, rows);
    wc = base;
    acc = reinterpret_cast<uint32_t*>(base + mm_wc_bytes());
    diff = acc + 2 * N;
    ulo = reinterpret_cast<uint8_t*>(diff + 2 * N);
    uhi = ulo + static_cast<size_t>(mm_mrows(R, rows)) * kWS;
    z = reinterpret_cast<uint16_t*>(ulo + mm_u_bytes(N, rows));
    r1 = z + static_cast<size_t>(mm_mrows(R, rows)) * kZS;
    r2 = r1 + 8 * N;
    ring = reinterpret_cast<uint32_t*>(aliased ? ulo : reinterpret_cast<uint8_t*>(r2 + 8 * N));
  }
  // A block of the pair round kernels (split_smem_bytes): WC of its prime
  // only; r1 its own residues of the 8 outputs at the coefficients of its
  // half [8][N / 2]; r2 the inbox of its CRT partner's residues of that half
  // [8][N / 2]; the ring after r2.
  __device__ SmemMM(unsigned char* base, int rows, PairBlock) {
    const int mr = split_mrows(GeoMM<N>::R, rows);
    wc = base;
    acc = reinterpret_cast<uint32_t*>(base + size_t(2) * kC * kWS);
    diff = acc + 2 * N;
    ulo = reinterpret_cast<uint8_t*>(diff + 2 * N);
    uhi = ulo + static_cast<size_t>(mr) * kWS;
    z = reinterpret_cast<uint16_t*>(uhi + static_cast<size_t>(mr) * kWS);
    r1 = z + static_cast<size_t>(mr) * kZS;
    r2 = r1 + 8 * N / 2;
    ring = reinterpret_cast<uint32_t*>(r2 + 8 * N / 2);
  }
};

// Per-prime tables in global memory, uint2 (w, Shoup companion) pairs:
// [0, R*C) TWf, [R*C, 2*R*C) TWi, then the forward R-NTT's R twiddles
// psi_R^brv(k), then the inverse's psi_R^-brv(k) (entry 0 of each unused).
template <int N>
struct TabMM {
  static constexpr int R = GeoMM<N>::R;
  static constexpr int TWF = 0, TWI = R * kC, PSF = 2 * R * kC, PSI = 2 * R * kC + R;
  static constexpr int STRIDE = 2 * R * kC + 2 * R;
};

struct ConstsMM {
  Mod m[kPrimes];
  uint2 c8[kPrimes];    // 2^8 mod p and its companion
  uint2 c16[kPrimes];   // 2^16 mod p and its companion
  int lazy[kPrimes];    // products of residues that fit a uint32 beside a value < 2p
  uint2 inv01;          // p0^-1 mod p1 and its companion
  uint32_t p01;         // p0 * p1 < 2^30
};

struct Gadget {
  int l, bg_bit;
  uint32_t offset;  // sum_j (Bg/2) * 2^(32 - (j+1)*bg_bit), as uint32
};

// Stage WC's limbs of both primes (uint8 [2][2][128][128]) into the padded
// rows of shared memory.  No barrier.
template <int N>
__device__ __forceinline__ void stage_wc(uint8_t* dst, const uint8_t* __restrict__ wc) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(wc);
  constexpr int words = kPrimes * 2 * kC * (kC / 4);
  for (int i = threadIdx.x; i < words; i += GeoMM<N>::T) {
    const int row = i / (kC / 4), w = i % (kC / 4);  // row over [prime][limb][128]
    *reinterpret_cast<uint32_t*>(dst + row * kWS + 4 * w) = __ldg(src + i);
  }
}

// out[row][n] = sum_k A[row][k] W[k][n] mod p for rows < M, A given by its
// u8 limbs (values below 2^16), W by its (symmetric, so stored n-major) u8
// limbs; result in [0, p) as u16 rows of kZS.  Each warp takes units of one
// 16-row tile against four 8-column tiles.  No barrier.
template <int N>
__device__ __forceinline__ void mma_mod(const uint8_t* alo, const uint8_t* ahi, int M,
                                        const uint8_t* wlo, const uint8_t* whi, uint16_t* out,
                                        Mod md, uint2 c8, uint2 c16) {
  using Ge = GeoMM<N>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int units = (M + 15) / 16 * 4;
#pragma unroll 1
  for (int unit = warp; unit < units; unit += Ge::WARPS) {
    const int row0 = (unit >> 2) * 16, nq = unit & 3;
    uint32_t al[4][4], ah[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int off = (row0 + g) * kWS + ks * 32 + tg * 4;
      al[ks][0] = ld32(alo + off);
      al[ks][1] = ld32(alo + off + 8 * kWS);
      al[ks][2] = ld32(alo + off + 16);
      al[ks][3] = ld32(alo + off + 8 * kWS + 16);
      ah[ks][0] = ld32(ahi + off);
      ah[ks][1] = ld32(ahi + off + 8 * kWS);
      ah[ks][2] = ld32(ahi + off + 16);
      ah[ks][3] = ld32(ahi + off + 8 * kWS + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n0 = nq * 32 + nt * 8;
      uint32_t c00[4] = {0u, 0u, 0u, 0u}, cmid[4] = {0u, 0u, 0u, 0u}, c11[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int off = (n0 + g) * kWS + ks * 32 + tg * 4;
        const uint32_t bl0 = ld32(wlo + off), bl1 = ld32(wlo + off + 16);
        const uint32_t bh0 = ld32(whi + off), bh1 = ld32(whi + off + 16);
        mma_u8(c00, al[ks], bl0, bl1);
        mma_u8(cmid, al[ks], bh0, bh1);
        mma_u8(cmid, ah[ks], bl0, bl1);
        mma_u8(c11, ah[ks], bh0, bh1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        if (row < M) {
          uint32_t v[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = 2 * h + i;
            // < 16.6e6 + 4p < 2^24
            v[i] = reduce(c00[c] + shoup(cmid[c], c8, md.p) + shoup(c11[c], c16, md.p), md);
          }
          *reinterpret_cast<uint32_t*>(out + row * kZS + n0 + 2 * tg) = v[0] | (v[1] << 16);
        }
      }
    }
  }
}

// Forward pre-step of digit rows 0 .. rows - 1: for each row j and column j2
// the negacyclic R-NTT of the digits x[j1, j2] mod p, times TWf, in [0, p),
// split into u8 limbs at A row j * R + k1, column j2.  A thread takes four
// consecutive columns of one row.  digit4(j, pos) gives row j's signed
// digits at pos .. pos + 3 (|digit| < p).  No barrier.
template <int N, class Digit4>
__device__ __forceinline__ void forward_pre(const Digit4& digit4, int rows, const uint2* tab,
                                            const SmemMM<N>& sm, uint32_t p) {
  using Ge = GeoMM<N>;
  using Tb = TabMM<N>;
  constexpr int R = Ge::R;
#pragma unroll 1
  for (int item = threadIdx.x; item < rows * (kC / 4); item += Ge::T) {
    const int j = item / (kC / 4), c0 = 4 * (item % (kC / 4));
    uint32_t x[R][4];
#pragma unroll
    for (int j1 = 0; j1 < R; ++j1) {
      const int4 d = digit4(j, j1 * kC + c0);
      const int dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[j1][q] = static_cast<uint32_t>(dd[q] < 0 ? dd[q] + static_cast<int>(p) : dd[q]);
    }
    // Cooley-Tukey, psi_R^brv(m + i): inputs < p, + 2p a stage
#pragma unroll
    for (int m = 1, t = R / 2; m < R; m *= 2, t /= 2) {
#pragma unroll
      for (int i = 0; i < m; ++i) {
        const uint2 s = __ldg(tab + Tb::PSF + m + i);
#pragma unroll
        for (int jj = 2 * i * t; jj < 2 * i * t + t; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t u = x[jj][q], v = shoup(x[jj + t][q], s, p);
            x[jj][q] = u + v;
            x[jj + t][q] = u - v + 2 * p;
          }
      }
    }
    // x[i] is A[brv(i)] (the permutation in the address: x stays in registers)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k1 = brv(i, Ge::LOG_R);
      const uint2* tw = tab + Tb::TWF + k1 * kC + c0;
      uint32_t lo = 0u, hi = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t v = csub(shoup(x[i][q], __ldg(tw + q), p), p);
        lo |= (v & 255u) << (8 * q);
        hi |= (v >> 8) << (8 * q);
      }
      const int off = (j * R + k1) * kWS + c0;
      *reinterpret_cast<uint32_t*>(sm.ulo + off) = lo;
      *reinterpret_cast<uint32_t*>(sm.uhi + off) = hi;
    }
  }
}

// Inverse post-step of the 8 outputs: for each output o and column j2, y =
// Z[o * R + k1][j2] times TWi (below 2p), the inverse negacyclic R-NTT
// (Gentleman-Sande, doubling a stage: below 2R p), reduced to [0, p) and
// stored at dst[o][j1 * C + j2].  No barrier.
template <int N>
__device__ __forceinline__ void inverse_post(const uint2* tab, const SmemMM<N>& sm,
                                             uint16_t* dst, Mod md) {
  using Ge = GeoMM<N>;
  using Tb = TabMM<N>;
  constexpr int R = Ge::R;
  const uint32_t p = md.p;
#pragma unroll 1
  for (int item = threadIdx.x; item < 8 * kC; item += Ge::T) {
    const int o = item / kC, j2 = item % kC;
    uint32_t a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k1 = brv(i, Ge::LOG_R);
      a[i] = shoup(sm.z[(o * R + k1) * kZS + j2], __ldg(tab + Tb::TWI + k1 * kC + j2), p);
    }
    uint32_t bound = 2 * p;
#pragma unroll
    for (int m = R, t = 1; m > 1; m /= 2, t *= 2) {
      const int h = m / 2;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const uint2 s = __ldg(tab + Tb::PSI + h + i);
#pragma unroll
        for (int jj = 2 * i * t; jj < 2 * i * t + t; ++jj) {
          const uint32_t u = a[jj], v = a[jj + t];
          a[jj] = u + v;
          a[jj + t] = shoup(u - v + bound, s, p);
        }
      }
      bound *= 2;
    }
#pragma unroll
    for (int j1 = 0; j1 < R; ++j1)
      dst[o * N + j1 * kC + j2] = static_cast<uint16_t>(reduce(a[j1], md));
  }
}

// Prime pi's constants by selects: indexing the kernel parameter's arrays
// with a loop variable would copy the struct to the stack.
__device__ __forceinline__ Mod mod_of(const ConstsMM& c, int pi) {
  return pi == 0 ? c.m[0] : c.m[1];
}
__device__ __forceinline__ uint2 c8_of(const ConstsMM& c, int pi) {
  return pi == 0 ? c.c8[0] : c.c8[1];
}
__device__ __forceinline__ uint2 c16_of(const ConstsMM& c, int pi) {
  return pi == 0 ? c.c16[0] : c.c16[1];
}
__device__ __forceinline__ int lazy_of(const ConstsMM& c, int pi) {
  return pi == 0 ? c.lazy[0] : c.lazy[1];
}

// Signed CRT value of residues mod p0 < p1 as a torus32: Garner's digit
// below p1, v = c0 + t1 p0 < p0 p1 < 2^30, v >= p0 p1 / 2 stands for v - p0 p1.
__device__ __forceinline__ uint32_t crt2(uint32_t c0, uint32_t c1, const ConstsMM& c) {
  const uint32_t p1 = c.m[1].p;
  const uint32_t t1 = csub(shoup(c1 + p1 - c0, c.inv01, p1), p1);
  uint32_t v = c0 + t1 * c.m[0].p;
  if (2 * v >= c.p01) v -= c.p01;
  return v;
}

// Where a thread stands in the key stream: the next row to read (v) and
// its slot.
struct StreamPos {
  int v = 0, slot = 0;
};

// The BK's rows as the MACs read them, round by round, prime 0 then prime
// 1, digit row by digit row (row v sits in slot v % depth; depth <= rows),
// each a run of 8 x N int16 in the prepared BK.  total: the rows of the
// launch (rounds x 2 x rows).  Each warp copies the words its threads read,
// with two 16-byte cp.async a thread and one commit group a row (lanes
// 8q .. 8q + 7 one 128-byte line of limb polynomials q and q + 4), and meets
// at __syncwarp around them: no barrier between warps, so the stream runs
// on through the block barriers of the transforms.
template <int N>
struct KeyStream {
  static constexpr uint32_t kRowBytes = static_cast<uint32_t>(mm_row_bytes(N));
  const int16_t* bk;        // round 0, prime 0
  long long round_stride;   // elements
  long long prime_stride;   // elements
  int rows, total, depth;
  bool aliased;             // the ring lies on U: rows stream only inside a MAC
  uint32_t ring;            // shared address
  uint32_t off;             // this thread's first 16 bytes in a row

  __device__ KeyStream(const SmemMM<N>& sm, const int16_t* bk_, long long round_stride_,
                       long long prime_stride_, int rows_, int rounds)
      : bk(bk_), round_stride(round_stride_), prime_stride(prime_stride_), rows(rows_),
        total(2 * rows_ * rounds), depth(mm_ring_rows(N, rows_)),
        aliased(mm_ring_aliased(N, rows_)), ring(shared_address(sm.ring)),
        off(4u * (((threadIdx.x & 31) >> 3) * (N / 2) + (threadIdx.x >> 5) * 32 +
                  4 * (threadIdx.x & 7))) {}
  // `rows_` rows from bk_ on (one prime's, of a pair round kernel's block)
  // through a ring of its own of `depth_` rows.
  __device__ KeyStream(const SmemMM<N>& sm, const int16_t* bk_, int rows_, int depth_)
      : bk(bk_), round_stride(0), prime_stride(0), rows(rows_), total(rows_), depth(depth_),
        aliased(false), ring(shared_address(sm.ring)),
        off(4u * (((threadIdx.x & 31) >> 3) * (N / 2) + (threadIdx.x >> 5) * 32 +
                  4 * (threadIdx.x & 7))) {}

  // The rows of round `round`, prime `pi`.
  __device__ const int16_t* rows_of(int round, int pi) const {
    return bk + round * round_stride + pi * prime_stride;
  }
  // This thread's part of the row at src into `slot`.
  __device__ void fill(const int16_t* src, int slot) const {
    const uint8_t* from = reinterpret_cast<const uint8_t*>(src) + off;
    const uint32_t to = ring + slot * kRowBytes + off;
    cp_async16(to, from);
    cp_async16(to + 8 * N, from + 8 * N);  // polynomials 4 .. 7
  }
  // A dedicated ring's first rows, at the launch's start.
  __device__ void start() const {
    if (!aliased) open(StreamPos{}, bk);
  }
  // The first `depth` rows of a prime (rows at cur) from at on: a dedicated
  // ring's at the launch's start, a ring on U's at each MAC's.
  __device__ void open(const StreamPos& at, const int16_t* cur) const {
    for (int k = 0, slot = at.slot; k < depth; ++k, slot = slot + 1 == depth ? 0 : slot + 1) {
      fill(cur + k * 8 * N, slot);
      cp_async_commit();
    }
  }
  // Row at.v is in its slot, for this warp: at most depth - 1 later rows'
  // groups are still in flight.
  __device__ void wait() const {
    switch (depth) {
      case 1: cp_async_wait<0>(); break;
      case 2: cp_async_wait<1>(); break;
      case 3: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncwarp();
  }
  // This warp has read row at.v: its slot takes row at.v + depth (at src)
  // if that is below `last`; advance.
  __device__ void release(StreamPos& at, int last, const int16_t* src) const {
    __syncwarp();
    if (at.v + depth < last) fill(src, at.slot);
    cp_async_commit();  // an empty group past `last`: the waits stay depth - 1
    ++at.v;
    if (++at.slot == depth) at.slot = 0;
  }
};

// TGSW external product of this block's ciphertext in the four-step domain:
//   delta[u] = sum_rows digit_row (x) BK[row][u]  (mod 2^32, u = 0, 1)
// digit4 as in forward_pre; ks the key stream, at round `round`'s first row
// (`at`, advanced past the round's 2 x rows); tabs the two primes' TabMM
// tables.  On return delta[u][e] holds coefficient E*tid + e.  The caller
// puts a barrier between its own shared-memory writes and this call, and
// one after it before anything writes r1 or r2.
template <int N, class Digit4>
__device__ __forceinline__ void external_product_mm(const Digit4& digit4, int rows,
                                                    const KeyStream<N>& ks, int round,
                                                    StreamPos& at,
                                                    const uint2* __restrict__ tabs,
                                                    const ConstsMM& cs, const SmemMM<N>& sm,
                                                    uint32_t (&delta)[2][GeoMM<N>::E]) {
  using Ge = GeoMM<N>;
  using Tb = TabMM<N>;
  constexpr int R = Ge::R, E = Ge::E;
  const int tid = threadIdx.x;
  const int M = rows * R;
  const int pos = E * tid, k1 = pos / kC, k2 = pos % kC;
#pragma unroll 1
  for (int pi = 0; pi < kPrimes; ++pi) {
    const Mod md = mod_of(cs, pi);
    const uint32_t p = md.p;
    const uint2* tab = tabs + pi * Tb::STRIDE;
    const uint8_t* wlo = sm.wc + (pi * 2) * kC * kWS;
    const uint8_t* whi = wlo + kC * kWS;
    const uint2 c8 = c8_of(cs, pi), c16 = c16_of(cs, pi);

    // forward: R-step and twiddle, then the C-step on the tensor cores
    forward_pre<N>(digit4, rows, tab, sm, p);
    __syncthreads();
    mma_mod<N>(sm.ulo, sm.uhi, M, wlo, whi, sm.z, md, c8, c16);
    __syncthreads();

    // MAC: this thread's coefficients pos, pos + 1 of all 8 outputs, the
    // key rows from the ring; a dedicated ring holds this prime's first
    // rows already, one on U gets them now
    uint32_t a[8][E];
#pragma unroll
    for (int o = 0; o < 8; ++o)
#pragma unroll
      for (int e = 0; e < E; ++e) a[o][e] = 0u;
    const int lazy = lazy_of(cs, pi);
    const int last = ks.aliased ? at.v + rows : ks.total;  // rows the ring may take
    const int16_t* cur = ks.rows_of(round, pi);  // this prime's rows, then the next prime's
    const int16_t* nxt = pi == 0 ? ks.rows_of(round, 1) : ks.rows_of(round + 1, 0);
    if (ks.aliased) ks.open(at, cur);
    // the row a release refills its slot with: row j + depth of this prime,
    // or past its last row, row j + depth - rows of the next
    const int16_t* src = ks.depth < rows ? cur + ks.depth * 8 * N : nxt;
    int pending = 0;
#pragma unroll 2  // the math of one row overlaps the next row's wait and loads
    for (int j = 0; j < rows; ++j) {
      ks.wait();
      if (pending == lazy) {
#pragma unroll
        for (int o = 0; o < 8; ++o)
#pragma unroll
          for (int e = 0; e < E; ++e) a[o][e] = reduce_2p(a[o][e], md);
        pending = 0;
      }
      ++pending;
      const uint32_t dz = *reinterpret_cast<const uint32_t*>(sm.z + (j * R + k1) * kZS + k2);
      const uint32_t d0 = dz & 0xffffu, d1 = dz >> 16;
      const uint32_t* w = sm.ring + at.slot * (8 * N / 2) + tid;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const uint32_t x = w[o * (N / 2)];
        a[o][0] += d0 * (x & 0xffffu);
        a[o][1] += d1 * (x >> 16);
      }
      ks.release(at, last, src);
      src = j + 1 + ks.depth == rows ? nxt : src + 8 * N;
    }
    // U was last read by the forward C-step, before the barrier above; a
    // ring on U is read to its end only after this one
    if (ks.aliased) __syncthreads();
    // the sums, in [0, p), as the inverse C-step's left operand: row
    // o * R + k1, column -k2 mod C (WCi's rows are WC's reversed)
#pragma unroll
    for (int o = 0; o < 8; ++o)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t s = reduce(a[o][e], md);
        const int off = (o * R + k1) * kWS + ((kC - k2 - e) & (kC - 1));
        sm.ulo[off] = static_cast<uint8_t>(s & 255u);
        sm.uhi[off] = static_cast<uint8_t>(s >> 8);
      }
    __syncthreads();
    mma_mod<N>(sm.ulo, sm.uhi, 8 * R, wlo, whi, sm.z, md, c8, c16);
    __syncthreads();
    inverse_post<N>(tab, sm, pi == 0 ? sm.r2 : sm.r1, md);
    __syncthreads();
  }
  // CRT and the recombination of the 4 BK limbs
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < E; ++e) delta[u][e] = 0u;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(sm.r2 + o * N + pos);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(sm.r1 + o * N + pos);
    delta[o / 4][0] += crt2(w0 & 0xffffu, w1 & 0xffffu, cs) << (8 * (o % 4));
    delta[o / 4][1] += crt2(w0 >> 16, w1 >> 16, cs) << (8 * (o % 4));
  }
}

// Signed gadget digits of X^t acc - acc (+ offset) in sm.diff; row j =
// bloc * l + level, four consecutive coefficients.
template <int N>
struct GadgetDigits4 {
  const uint32_t* u;  // [2][N]
  Gadget g;
  __device__ __forceinline__ int4 operator()(int j, int pos) const {
    const int bloc = j / g.l, lv = j - bloc * g.l;
    const int shift = 32 - (lv + 1) * g.bg_bit;
    const uint32_t mask = (1u << g.bg_bit) - 1u;
    const int half = 1 << (g.bg_bit - 1);
    const uint4 w = *reinterpret_cast<const uint4*>(u + bloc * N + pos);
    return make_int4(static_cast<int>((w.x >> shift) & mask) - half,
                     static_cast<int>((w.y >> shift) & mask) - half,
                     static_cast<int>((w.z >> shift) & mask) - half,
                     static_cast<int>((w.w >> shift) & mask) - half);
  }
};

template <int N>
struct RowDigits4 {
  const int32_t* d;  // [rows][N] of this block's ciphertext
  __device__ __forceinline__ int4 operator()(int j, int pos) const {
    return __ldg(reinterpret_cast<const int4*>(d + j * N + pos));
  }
};

// X^t a [k] = +-a[(k - t) mod N], negated when (k - t) mod 2N >= N; t in [0, 2N).
template <int N>
__device__ __forceinline__ uint32_t rotated(const uint32_t* a, int t, int k) {
  int src = k - t;
  if (src < 0) src += 2 * N;
  const bool neg = src >= N;
  src = neg ? src - N : src;
  return neg ? 0u - a[src] : a[src];
}

// sm.diff = X^t acc - acc + offset.  Ends with a barrier.
template <int N>
__device__ __forceinline__ void rotate_diff(const SmemMM<N>& sm, int t, uint32_t offset) {
#pragma unroll
  for (int e = 0; e < GeoMM<N>::E; ++e) {
    const int k = threadIdx.x + e * GeoMM<N>::T;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t* a = sm.acc + u * N;
      sm.diff[u * N + k] = rotated<N>(a, t, k) - a[k] + offset;
    }
  }
  __syncthreads();
}

// acc += delta at this thread's coefficients; then a barrier.
template <int N>
__device__ __forceinline__ void add_delta(const SmemMM<N>& sm,
                                          const uint32_t (&delta)[2][GeoMM<N>::E]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    uint2* a = reinterpret_cast<uint2*>(sm.acc + u * N + GeoMM<N>::E * threadIdx.x);
    const uint2 v = *a;
    *a = make_uint2(v.x + delta[u][0], v.y + delta[u][1]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------- kernels

// K2-mm: delta[m] = digits[m] (x) bk round slice, one ciphertext a block.
template <int N>
__global__ void __launch_bounds__(GeoMM<N>::T, 1) external_product_mm_kernel(
    const int32_t* __restrict__ digits, const int16_t* __restrict__ bk, long long prime_stride,
    const uint2* __restrict__ tabs, const uint8_t* __restrict__ wc, int32_t* __restrict__ out,
    int rows, ConstsMM cs) {
  extern __shared__ uint4 smem_raw[];
  const SmemMM<N> sm(reinterpret_cast<unsigned char*>(smem_raw), rows);
  const long long m = blockIdx.x;
  const KeyStream<N> ks(sm, bk, 0, prime_stride, rows, 1);
  ks.start();
  stage_wc<N>(sm.wc, wc);
  __syncthreads();
  const RowDigits4<N> dig{digits + m * rows * N};
  uint32_t delta[2][GeoMM<N>::E];
  StreamPos at;
  external_product_mm<N>(dig, rows, ks, 0, at, tabs, cs, sm, delta);
#pragma unroll
  for (int u = 0; u < 2; ++u)
    *reinterpret_cast<int2*>(out + (m * 2 + u) * N + 2 * threadIdx.x) =
        make_int2(delta[u][0], delta[u][1]);
}

// K3-mm: acc_out[m] = acc[m] + ExtProd(Decomp(X^t[m] acc - acc), bk round slice).
template <int N>
__global__ void __launch_bounds__(GeoMM<N>::T, 1) cmux_round_mm_kernel(
    const int32_t* __restrict__ acc_in, const int32_t* __restrict__ t,
    const int16_t* __restrict__ bk, long long prime_stride, const uint2* __restrict__ tabs,
    const uint8_t* __restrict__ wc, int32_t* __restrict__ acc_out, Gadget g, ConstsMM cs) {
  extern __shared__ uint4 smem_raw[];
  const int rows = 2 * g.l;
  const SmemMM<N> sm(reinterpret_cast<unsigned char*>(smem_raw), rows);
  const long long m = blockIdx.x;
  const KeyStream<N> ks(sm, bk, 0, prime_stride, rows, 1);
  ks.start();
  for (int k = threadIdx.x; k < 2 * N; k += GeoMM<N>::T)
    sm.acc[k] = static_cast<uint32_t>(acc_in[m * 2 * N + k]);
  stage_wc<N>(sm.wc, wc);
  __syncthreads();
  rotate_diff<N>(sm, t[m], g.offset);
  const GadgetDigits4<N> dig{sm.diff, g};
  uint32_t delta[2][GeoMM<N>::E];
  StreamPos at;
  external_product_mm<N>(dig, rows, ks, 0, at, tabs, cs, sm, delta);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int k = u * N + 2 * threadIdx.x;
    *reinterpret_cast<int2*>(acc_out + m * 2 * N + k) =
        make_int2(sm.acc[k] + delta[u][0], sm.acc[k + 1] + delta[u][1]);
  }
}

// ------------------------------------------- K2-mm and K3-mm over a cluster
//
// One round of one ciphertext is the work of a cluster of two blocks, block
// rank = pi, one a prime: block pi stages only its prime's WC limbs
// (36,864 B), streams only its prime's key rows, and runs that prime's
// forward transforms, MAC and 8 inverse transforms; the two primes are
// independent until the CRT.  The CRT needs both primes' residues: each
// block stores the residues of the other half of the coefficients into its
// partner's inbox by distributed shared memory, the cluster meets, and each
// block writes the outputs of its half (half pi) from its own shared memory.
// Both blocks form the digits of X^t acc - acc (cheap).  The arithmetic is
// the parent design's: the same lazy Shoup reductions, int8 mma.sync C-steps
// and CRT, so the outputs are bit-identical to external_product_mm_kernel<N>
// / cmux_round_mm_kernel<N> above (one ciphertext a block, all of the round
// on one SM), which the wrappers keep for batches that fill the card.
//
// kFull: K3-mm (acc in, acc + delta out); else K2-mm (digits in, delta out).

// The two halves of cluster.sync(), and an arrival that orders nothing (the
// launch's: every block of the cluster has started before a partner's
// shared memory is written).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Issue WC's limbs of one prime (uint8 [2][128][128]) into the padded rows
// of shared memory, 16 bytes a cp.async, as one commit group (the caller
// waits for it before the first C-step).
template <int N>
__device__ __forceinline__ void stage_wc_async(uint8_t* dst, const uint8_t* __restrict__ wc) {
  const uint32_t to = shared_address(dst);
  constexpr int pieces = 2 * kC * (kC / 16);
  for (int i = threadIdx.x; i < pieces; i += GeoMM<N>::T)
    cp_async16(to + (i / (kC / 16)) * kWS + 16 * (i % (kC / 16)), wc + 16 * i);
  cp_async_commit();
}

// cp.async.wait_group d for d = 1 .. 4: all but the d latest groups landed.
__device__ __forceinline__ void cp_async_wait_upto(int d) {
  switch (d) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// inverse_post of a pair block's 8 outputs, each result stored where the
// CRT reads it: the coefficients of the block's half `pi` into `mine`
// [8][N/2], those of the other half into the CRT partner's inbox `theirs`
// [8][N/2] (distributed shared memory stores).  No barrier.
template <int N>
__device__ __forceinline__ void inverse_post_split(const uint2* tab, const SmemMM<N>& sm,
                                                   uint16_t* mine, uint16_t* theirs, int pi,
                                                   Mod md) {
  using Ge = GeoMM<N>;
  using Tb = TabMM<N>;
  constexpr int R = Ge::R;
  const uint32_t p = md.p;
#pragma unroll 1
  for (int item = threadIdx.x; item < 8 * kC; item += Ge::T) {
    const int o = item / kC, j2 = item % kC;
    uint32_t a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k1 = brv(i, Ge::LOG_R);
      a[i] = shoup(sm.z[(o * R + k1) * kZS + j2], __ldg(tab + Tb::TWI + k1 * kC + j2), p);
    }
    uint32_t bound = 2 * p;
#pragma unroll
    for (int m = R, t = 1; m > 1; m /= 2, t *= 2) {
      const int h = m / 2;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const uint2 s = __ldg(tab + Tb::PSI + h + i);
#pragma unroll
        for (int jj = 2 * i * t; jj < 2 * i * t + t; ++jj) {
          const uint32_t u = a[jj], v = a[jj + t];
          a[jj] = u + v;
          a[jj + t] = shoup(u - v + bound, s, p);
        }
      }
      bound *= 2;
    }
    // coefficient j1 C + j2 lies in half j1 / (R / 2)
#pragma unroll
    for (int j1 = 0; j1 < R; ++j1) {
      uint16_t* d = (j1 < R / 2) == (pi == 0) ? mine : theirs;
      d[o * (N / 2) + (j1 % (R / 2)) * kC + j2] = static_cast<uint16_t>(reduce(a[j1], md));
    }
  }
}

template <int N, bool kFull>
__device__ __forceinline__ void split_round(const int32_t* __restrict__ digits,
                                            const int32_t* __restrict__ acc_in,
                                            const int32_t* __restrict__ t,
                                            const int16_t* __restrict__ bk,
                                            long long prime_stride,
                                            const uint2* __restrict__ tabs,
                                            const uint8_t* __restrict__ wc,
                                            int32_t* __restrict__ out, int rows, Gadget g,
                                            const ConstsMM& cs) {
  using Ge = GeoMM<N>;
  using Tb = TabMM<N>;
  constexpr int R = Ge::R, E = Ge::E;
  extern __shared__ uint4 smem_raw[];
  const SmemMM<N> sm(reinterpret_cast<unsigned char*>(smem_raw), rows, PairBlock{});
  const int pi = static_cast<int>(blockIdx.x & 1);
  const long long m = blockIdx.x / 2;
  const KeyStream<N> ks(sm, bk + pi * prime_stride, rows, split_ring_rows(N, rows));
  cluster_arrive_relaxed();  // met before the first store to the partner
  // WC and the first key rows land while the digits are formed
  stage_wc_async<N>(sm.wc, wc + pi * 2 * kC * kC);
  ks.start();
  if constexpr (kFull)
    for (int k = threadIdx.x; k < 2 * N; k += Ge::T)
      sm.acc[k] = static_cast<uint32_t>(acc_in[m * 2 * N + k]);
  __syncthreads();

  const Mod md = mod_of(cs, pi);
  const uint32_t p = md.p;
  const uint2* tab = tabs + pi * Tb::STRIDE;
  const uint8_t* wlo = sm.wc;
  const uint8_t* whi = wlo + kC * kWS;
  const uint2 c8 = c8_of(cs, pi), c16 = c16_of(cs, pi);

  // forward: R-step and twiddle of the rows, then the C-step
  if constexpr (kFull) {
    rotate_diff<N>(sm, t[m], g.offset);
    forward_pre<N>(GadgetDigits4<N>{sm.diff, g}, rows, tab, sm, p);
  } else {
    forward_pre<N>(RowDigits4<N>{digits + m * rows * N}, rows, tab, sm, p);
  }
  cp_async_wait_upto(ks.depth);  // WC: only the ring's groups may be in flight
  __syncthreads();
  mma_mod<N>(sm.ulo, sm.uhi, rows * R, wlo, whi, sm.z, md, c8, c16);
  __syncthreads();

  // MAC: this thread's coefficients pos, pos + 1 of all 8 outputs over the
  // rows, the key rows from the ring
  const int tid = threadIdx.x;
  const int pos = E * tid, k1 = pos / kC, k2 = pos % kC;
  uint32_t a[8][E];
#pragma unroll
  for (int o = 0; o < 8; ++o)
#pragma unroll
    for (int e = 0; e < E; ++e) a[o][e] = 0u;
  const int lazy = lazy_of(cs, pi);
  const int16_t* src = ks.bk + ks.depth * 8 * N;  // the row a release refills its slot with
  StreamPos at;
  int pending = 0;
#pragma unroll 2
  for (int j = 0; j < rows; ++j) {
    ks.wait();
    if (pending == lazy) {
#pragma unroll
      for (int o = 0; o < 8; ++o)
#pragma unroll
        for (int e = 0; e < E; ++e) a[o][e] = reduce_2p(a[o][e], md);
      pending = 0;
    }
    ++pending;
    const uint32_t dz = *reinterpret_cast<const uint32_t*>(sm.z + (j * R + k1) * kZS + k2);
    const uint32_t d0 = dz & 0xffffu, d1 = dz >> 16;
    const uint32_t* w = sm.ring + at.slot * (8 * N / 2) + tid;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const uint32_t x = w[o * (N / 2)];
      a[o][0] += d0 * (x & 0xffffu);
      a[o][1] += d1 * (x >> 16);
    }
    ks.release(at, rows, src);
    src += 8 * N;
  }

  // the 8 sums, in [0, p), as the inverse C-step's left operand: row
  // o * R + k1, column -k2 mod C (U was last read by the forward C-step,
  // before the barrier above)
#pragma unroll
  for (int o = 0; o < 8; ++o)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint32_t v = reduce(a[o][e], md);
      const int off = (o * R + k1) * kWS + ((kC - k2 - e) & (kC - 1));
      sm.ulo[off] = static_cast<uint8_t>(v & 255u);
      sm.uhi[off] = static_cast<uint8_t>(v >> 8);
    }
  __syncthreads();
  mma_mod<N>(sm.ulo, sm.uhi, 8 * R, wlo, whi, sm.z, md, c8, c16);
  __syncthreads();
  cluster_wait();  // the launch's arrival, before the first remote store
  // the residues of the other half go to the CRT partner's inbox
  inverse_post_split<N>(tab, sm, sm.r1, cg::this_cluster().map_shared_rank(sm.r2, pi ^ 1), pi,
                        md);
  cluster_arrive();  // both primes' residues of each half are in place
  cluster_wait();

  // CRT of both polynomials at the coefficients of half pi, two a thread,
  // from this block's shared memory alone
  const uint16_t* r0 = pi == 0 ? sm.r1 : sm.r2;  // prime 0's residues
  const uint16_t* r1 = pi == 0 ? sm.r2 : sm.r1;
#pragma unroll 1
  for (int item = tid; item < 2 * (N / 4); item += Ge::T) {
    const int u = item / (N / 4), kh = 2 * (item % (N / 4)), k = pi * (N / 2) + kh;
    uint32_t d0 = 0u, d1 = 0u;
#pragma unroll
    for (int limb = 0; limb < 4; ++limb) {
      const int o = u * 4 + limb;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r0 + o * (N / 2) + kh);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r1 + o * (N / 2) + kh);
      d0 += crt2(w0 & 0xffffu, w1 & 0xffffu, cs) << (8 * limb);
      d1 += crt2(w0 >> 16, w1 >> 16, cs) << (8 * limb);
    }
    if constexpr (kFull) {
      d0 += sm.acc[u * N + k];
      d1 += sm.acc[u * N + k + 1];
    }
    *reinterpret_cast<int2*>(out + (m * 2 + u) * N + k) =
        make_int2(static_cast<int>(d0), static_cast<int>(d1));
  }
}

// K2-mm on a cluster pair a ciphertext (split_round).
template <int N>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(GeoMM<N>::T, 1)
    external_product_mm_pair_kernel(const int32_t* __restrict__ digits,
                                    const int16_t* __restrict__ bk, long long prime_stride,
                                    const uint2* __restrict__ tabs,
                                    const uint8_t* __restrict__ wc, int32_t* __restrict__ out,
                                    int rows, ConstsMM cs) {
  split_round<N, false>(digits, nullptr, nullptr, bk, prime_stride, tabs, wc, out, rows,
                        Gadget{}, cs);
}

// K3-mm on a cluster pair a ciphertext (split_round).
template <int N>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(GeoMM<N>::T, 1)
    cmux_round_mm_pair_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ t,
                              const int16_t* __restrict__ bk, long long prime_stride,
                              const uint2* __restrict__ tabs, const uint8_t* __restrict__ wc,
                              int32_t* __restrict__ acc_out, Gadget g, ConstsMM cs) {
  split_round<N, true>(nullptr, acc_in, t, bk, prime_stride, tabs, wc, acc_out, 2 * g.l, g, cs);
}

// K4-mm: all n rounds; block b owns ciphertext b; BK int16 [2][n][2l][8][N].
template <int N>
__global__ void __launch_bounds__(GeoMM<N>::T, 1) blind_rotate_mm_kernel(
    const int32_t* __restrict__ acc0, const int32_t* __restrict__ abar,
    const int16_t* __restrict__ bk, const uint2* __restrict__ tabs,
    const uint8_t* __restrict__ wc, int32_t* __restrict__ acc_out, int n, Gadget g,
    ConstsMM cs) {
  extern __shared__ uint4 smem_raw[];
  const int rows = 2 * g.l;
  const SmemMM<N> sm(reinterpret_cast<unsigned char*>(smem_raw), rows);
  const long long b = blockIdx.x;
  const long long round_stride = static_cast<long long>(rows) * 8 * N;
  const KeyStream<N> ks(sm, bk, round_stride, round_stride * n, rows, n);
  ks.start();  // the first rows land while WC is staged
  for (int k = threadIdx.x; k < 2 * N; k += GeoMM<N>::T)
    sm.acc[k] = static_cast<uint32_t>(acc0[b * 2 * N + k]);
  stage_wc<N>(sm.wc, wc);
  __syncthreads();
  const GadgetDigits4<N> dig{sm.diff, g};
  StreamPos at;
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    rotate_diff<N>(sm, abar[b * n + j], g.offset);
    uint32_t delta[2][GeoMM<N>::E];
    external_product_mm<N>(dig, rows, ks, j, at, tabs, cs, sm, delta);
    add_delta<N>(sm, delta);
  }
  for (int k = threadIdx.x; k < 2 * N; k += GeoMM<N>::T)
    acc_out[b * 2 * N + k] = static_cast<int32_t>(sm.acc[k]);
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
  r.x = w % p;
  r.y = static_cast<uint32_t>((static_cast<unsigned long long>(r.x) << 32) / p);
  return r;
}

// Two primes, ascending, below 2^15 (the limb split takes residues below
// 2^15; pallas_blind.supported's envelope).
bool primes_ok(int p0, int p1) { return p0 > 256 && p0 < p1 && p1 < (1 << 15); }

ConstsMM make_consts(int p0, int p1) {
  ConstsMM c{};
  const uint32_t pr[2] = {static_cast<uint32_t>(p0), static_cast<uint32_t>(p1)};
  for (int i = 0; i < 2; ++i) {
    c.m[i] = make_mod(pr[i]);
    c.c8[i] = shoup_pair(256u, pr[i]);
    c.c16[i] = shoup_pair(65536u, pr[i]);
    c.lazy[i] = static_cast<int>((0x100000000ull - 2 * pr[i]) / ((pr[i] - 1ull) * (pr[i] - 1ull)));
  }
  c.inv01 = shoup_pair(powmod(pr[0] % pr[1], pr[1] - 2, pr[1]), pr[1]);
  c.p01 = pr[0] * pr[1];
  return c;
}

// Whether a launch of the kernel with `bytes` of dynamic shared memory may
// go ahead: at most kMaxSmem, and within the limit the kernel was opted in
// to on this device (once; `state` is the instance's own, launch_once.cuh).
template <class Kernel>
bool allow_smem(redsec::PerDevice& state, Kernel kernel, size_t bytes) {
  return bytes <= kMaxSmem && redsec::opt_in_smem(state, kernel, bytes) == cudaSuccess;
}

bool n_ok(int N) { return N == 256 || N == 1024; }
bool rows_ok(int N, int rows) { return rows > 0 && mm_smem_bytes(N, rows) <= kMaxSmem; }
// The key's rows are copied 16 bytes a cp.async, which takes 16-byte
// aligned addresses.
bool bk_ok(const int16_t* bk) { return reinterpret_cast<uintptr_t>(bk) % 16 == 0; }

// The round kernels at `split` blocks a ciphertext: 1 (one a block) or 2
// (a prime a block, a cluster pair), with the block fitting.
bool split_ok(int N, int rows, int split) {
  if (split == 1) return rows_ok(N, rows);
  return split == 2 && rows > 0 && split_ring_rows(N, rows) >= 1;
}
size_t round_smem_bytes(int N, int rows, int split) {
  return split == 1 ? mm_smem_bytes(N, rows) : split_smem_bytes(N, rows);
}

using ExtKernel = void (*)(const int32_t*, const int16_t*, long long, const uint2*,
                           const uint8_t*, int32_t*, int, ConstsMM);
using CmuxKernel = void (*)(const int32_t*, const int32_t*, const int16_t*, long long,
                            const uint2*, const uint8_t*, int32_t*, Gadget, ConstsMM);

// The instance of each round kernel at `split` (checked by split_ok), with
// its own shared-memory opt-in state.
template <int N>
ExtKernel ext_kernel(int split, redsec::PerDevice*& state) {
  static redsec::PerDevice s1, s2;
  state = split == 1 ? &s1 : &s2;
  return split == 1 ? external_product_mm_kernel<N> : external_product_mm_pair_kernel<N>;
}
template <int N>
CmuxKernel cmux_kernel(int split, redsec::PerDevice*& state) {
  static redsec::PerDevice s1, s2;
  state = split == 1 ? &s1 : &s2;
  return split == 1 ? cmux_round_mm_kernel<N> : cmux_round_mm_pair_kernel<N>;
}

// out[0]: ciphertexts a launch of `kernel` runs at once on the current
// device (blocks at split 1, cluster pairs at 2); out[1],
// out[2]: its registers and local bytes a thread.
int round_occupancy(redsec::PerDevice& state, const void* kernel, int split, int threads,
                    size_t bytes, int* out) {
  if (!allow_smem(state, kernel, bytes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  int at_once = 0;
  if (e == cudaSuccess && split == 1) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&at_once, kernel, threads, bytes);
    at_once *= redsec::sm_count();
  } else if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split * 1024);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    e = cudaOccupancyMaxActiveClusters(&at_once, kernel, &cfg);
  }
  out[0] = at_once;
  out[1] = fa.numRegs;
  out[2] = static_cast<int>(fa.localSizeBytes);
  return static_cast<int>(e);
}

}  // namespace

#define REDSEC_DISPATCH_MM(N_, ...)                             \
  switch (N_) {                                                 \
    case 256: { constexpr int NN = 256; __VA_ARGS__; break; }   \
    case 1024: { constexpr int NN = 1024; __VA_ARGS__; break; } \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

extern "C" {

// The layout of a launch at N and `rows` digit rows: out[0] dynamic shared
// bytes, out[1] rows of the C-steps' operands and results (Mr), out[2]
// bytes of U, out[3] threads a block, out[4] key rows in the ring, out[5] 1
// if the ring lies on U.  Non-zero for N without an instance or rows that do
// not fit a block.
int redsec_mm_layout(int N, int rows, int* out) {
  if (!n_ok(N) || !rows_ok(N, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = static_cast<int>(mm_smem_bytes(N, rows));
  out[1] = mm_mrows(N / kC, rows);
  out[2] = static_cast<int>(mm_u_bytes(N, rows));
  out[3] = N / 2;
  out[4] = mm_ring_rows(N, rows);
  out[5] = mm_ring_aliased(N, rows) ? 1 : 0;
  return 0;
}

// The round kernels' layout at N, `rows` digit rows and `split` blocks a
// ciphertext (1: one a block; 2: a cluster pair, split_round), of K3-mm
// (full) or K2-mm: out[0] dynamic shared bytes, out[1] rows of the C-steps'
// operands and results, out[2] threads a block, out[3] key rows in the
// ring, out[4] ciphertexts the current device runs at once (blocks an SM
// times SMs at split 1, else cluster pairs, from the occupancy calculator),
// out[5] registers a thread and out[6] local (spilled) bytes a thread of the
// instance.  Non-zero for what the kernels do not take.
int redsec_round_mm_layout(int N, int rows, int split, int full, int* out) {
  if (!n_ok(N) || !split_ok(N, rows, split)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = round_smem_bytes(N, rows, split);
  out[0] = static_cast<int>(bytes);
  out[1] = split == 1 ? mm_mrows(N / kC, rows) : split_mrows(N / kC, rows);
  out[2] = N / 2;
  out[3] = split == 1 ? mm_ring_rows(N, rows) : split_ring_rows(N, rows);
  REDSEC_DISPATCH_MM(N, {
    redsec::PerDevice* state = nullptr;
    const void* kernel = full ? reinterpret_cast<const void*>(cmux_kernel<NN>(split, state))
                              : reinterpret_cast<const void*>(ext_kernel<NN>(split, state));
    return round_occupancy(*state, kernel, split, NN / 2, bytes, out + 4);
  });
  return 0;
}

// K2-mm: delta[M, 2, N] = digits[M, rows, N] (x) bk[2][rows][8][N] (prime
// stride prime_stride elements); tabs uint2 [2][TabMM stride], wc uint8
// [2][2][128][128]; `split` blocks a ciphertext (redsec_round_mm_layout).
int redsec_external_product_mm(const int32_t* digits, const int16_t* bk, long long prime_stride,
                               const uint2* tabs, const uint8_t* wc, int32_t* delta, int M,
                               int N, int rows, int p0, int p1, int split, cudaStream_t stream) {
  if (M <= 0 || !primes_ok(p0, p1) || !n_ok(N) || !split_ok(N, rows, split) || !bk_ok(bk) ||
      !bk_ok(bk + prime_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConstsMM cs = make_consts(p0, p1);
  const size_t bytes = round_smem_bytes(N, rows, split);
  REDSEC_DISPATCH_MM(N, {
    redsec::PerDevice* state = nullptr;
    const ExtKernel kernel = ext_kernel<NN>(split, state);
    if (!allow_smem(*state, kernel, bytes)) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<M * split, GeoMM<NN>::T, bytes, stream>>>(digits, bk, prime_stride, tabs, wc, delta,
                                                       rows, cs);
  });
  return static_cast<int>(cudaGetLastError());
}

// K3-mm: acc_out[M, 2, N] = acc + ExtProd(Decomp(X^t[m] acc - acc), bk round);
// `split` as for K2-mm.
int redsec_cmux_round_mm(const int32_t* acc, const int32_t* t, const int16_t* bk,
                         long long prime_stride, const uint2* tabs, const uint8_t* wc,
                         int32_t* out, int M, int N, int l, int bg_bit, uint32_t offset, int p0,
                         int p1, int split, cudaStream_t stream) {
  if (M <= 0 || l <= 0 || bg_bit <= 0 || l * bg_bit > 32 || !primes_ok(p0, p1) ||
      !n_ok(N) || !split_ok(N, 2 * l, split) || !bk_ok(bk) || !bk_ok(bk + prime_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConstsMM cs = make_consts(p0, p1);
  const Gadget g{l, bg_bit, offset};
  const size_t bytes = round_smem_bytes(N, 2 * l, split);
  REDSEC_DISPATCH_MM(N, {
    redsec::PerDevice* state = nullptr;
    const CmuxKernel kernel = cmux_kernel<NN>(split, state);
    if (!allow_smem(*state, kernel, bytes)) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<M * split, GeoMM<NN>::T, bytes, stream>>>(acc, t, bk, prime_stride, tabs, wc, out,
                                                       g, cs);
  });
  return static_cast<int>(cudaGetLastError());
}

// K4-mm: all n CMUX rounds; bk int16 [2][n][2l][8][N] in the four-step
// order, abar int32 [B][n].
int redsec_blind_rotate_mm(const int32_t* acc0, const int32_t* abar, const int16_t* bk,
                           const uint2* tabs, const uint8_t* wc, int32_t* out, int B, int n,
                           int N, int l, int bg_bit, uint32_t offset, int p0, int p1,
                           cudaStream_t stream) {
  if (B <= 0 || n <= 0 || l <= 0 || bg_bit <= 0 || l * bg_bit > 32 || !primes_ok(p0, p1) ||
      !n_ok(N) || !rows_ok(N, 2 * l) || !bk_ok(bk))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConstsMM cs = make_consts(p0, p1);
  const Gadget g{l, bg_bit, offset};
  const size_t bytes = mm_smem_bytes(N, 2 * l);
  REDSEC_DISPATCH_MM(N, {
    static redsec::PerDevice smem;
    if (!allow_smem(smem, blind_rotate_mm_kernel<NN>, bytes))
      return static_cast<int>(cudaErrorInvalidValue);
    blind_rotate_mm_kernel<NN><<<B, GeoMM<NN>::T, bytes, stream>>>(acc0, abar, bk, tabs, wc, out,
                                                                   n, g, cs);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// the library's Python module (py_entries.cuh)
REDSEC_PY_MODULE(blind_mm, REDSEC_PY_FN(redsec_mm_layout), REDSEC_PY_FN(redsec_round_mm_layout),
                 REDSEC_PY_LAUNCH(redsec_external_product_mm),
                 REDSEC_PY_LAUNCH(redsec_cmux_round_mm),
                 REDSEC_PY_LAUNCH(redsec_blind_rotate_mm))
