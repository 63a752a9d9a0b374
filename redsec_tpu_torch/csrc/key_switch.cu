// The PBS key switch for Hopper (sm_90a) on the int8 tensor cores, a Python
// module of C entries (py_entries.cuh) under
// redsec_tpu_torch/crypto/kernels.py::key_switch.
//
//   out[b, c] = -sum_r dig[b, r] * ksk[r, c]  (mod 2^32),  out[b, n] += b_n[b]
//
// a int32 [B, N] (the extracted mask), b_n int32 [B] (any stride), the
// multiply-form key-switching key ksk [N t, n + 1] held as its four
// sign-balanced int8 limbs in the tiled order of kernels.py::ksk_tiles, out
// int32 [B, n + 1].  dig[b, j t + l] = ((a[b, j] + prec) >> (32 - (l + 1)
// basebit)) & (2^basebit - 1), the digits of bootstrap.py::RoundOps.ks_digits;
// they never go to memory.
//
// What it replaces: no Pallas kernel.  The JAX package runs this product as
// one XLA dot_general a limb over its int8 ksk_limbs [4, N t, n + 1] on the
// MXU (redsec_tpu/crypto/bootstrap.py:456, RoundOps.key_switch); the port ran
// it as torch digits and device.int32_matmul, which split the int32 key into
// four 8-bit limbs at every call and multiplied them in fp32 on the CUDA
// cores.  Here the limbs are made once, at crypto/bootstrap.py::
// prepare_cloud_key, and the result is the same sum mod 2^32, bit for bit.
//
// Formulation (the JAX package's, in exact integers):
//   ssum = sum_{i < 4} 2^(8 i) (dig @ limb_i)  mod 2^32
// with limb_i in [-128, 127] and dig in [0, 2^basebit).  Each limb product is
// an u8 x s8 product with int32 accumulation on mma.sync m16n8k32; its sums
// are exact, since N t (2^basebit - 1) 128 < 2^31 for every set of
// crypto/params.py (the largest: large_v2, 131,072 x 3 x 128; large,
// 147,456 x 1 x 128); the wrapper refuses a key above that.  The shifts and
// the negation wrap in uint32 in the epilogue.
//
// Bound on the H100: 2 B N t (n + 1) 4 int8 operations at 1,979e12 a second
// against the key's bytes, 4 N t (n + 1), read once at 3.35e12.  medium_v2's
// key (65,536 x 3,073, 805 MB): 0.417 ms of operations at B = 512, 0.24 ms of
// bytes at any B (B = 196: 0.16 ms of operations), so the 512-batches are
// bound by operations and the 196-batch by bytes.  The design reads every
// key byte once a call and builds no digit in memory: its own limit is the
// issue rate of mma.sync (about 0.66 of the tensor cores' peak here, see
// schoolbook.cu) and the digit arithmetic beside it.
//
// Layout.  The contraction's order is free, so the key's rows are prepared
// in the order the kernel walks: chunks of 16 coefficients, and in each the
// levels two at a time, one k-step of 32 (16 coefficients at level 2p, then
// the same 16 at level 2p + 1; t odd adds a zero level).  For a column
// group of 8 and one k-step the four limbs' 1,024 bytes are mma.sync's B
// fragments as the lanes hold them: limb pair q, lane 4 g + tq, 16 bytes
// (limb 2q at k 4 tq .. + 3 and 16 + 4 tq .. + 3 of column g, then limb
// 2q + 1), so a lane reads its fragments of two limbs with one 16-byte
// shared load and a warp 512 contiguous bytes.  A group's k-steps follow
// each other, so a block's stage of a group is one contiguous run.
//
// Design.  A block is 8 warps; it holds 16 MT rows (ciphertexts) a warp, all
// 128 MT rows of its batch tile (MT = 4: 512, one tile at the port's PBS
// chunk of 512), for CG column groups (8 CG columns x 4 limbs, CG = 8 / MT),
// so that each key byte is read from device memory by one block only.  The
// key's rows are split over blockIdx.y (the wrapper picks the split that
// fills the card's SMs with the fewest wasted waves, kernels.py::
// key_switch_layout); the splits' partial sums meet by int32 atomics into a
// zeroed output (addition mod 2^32 is order-free: the result is exact and
// the same every run), one split writes plainly.  The block walks its chunks
// through a ring of 3 stages filled by 16-byte cp.async: each stage holds
// the chunk's 16 words of the mask for each of the block's rows (64 bytes
// a row) and its key run for each group.  A lane reads the mask words of its
// rows g and g + 8 (columns 4 tq .. + 3) for the chunk, adds the rounding
// offset and keeps them as byte planes (plane b: byte b of the four words);
// a k-step's A fragment is then, for each level, a shift and a mask of one
// plane (two where a digit crosses a byte), with the digit plan (bits x
// levels: the three of crypto/params.py and the three more the noise-budget
// experiments set) a template parameter so that every shift is a constant.
// Digits made from the words themselves (four shifts, three permutes and a
// mask a word) held medium_v2 [512] at 1.67 ms, against 1.09 ms with the
// planes, on an H100 at 700 W.  Every fragment
// feeds 4 CG mma.sync; each shared load of the key, 2 limbs of MT m-tiles.
// The accumulators (MT x CG x 4 limbs x 4 words a lane) stay in registers
// to the end, where each lane recombines its limbs, negates, adds b_n in
// column n (first split only) and stores or adds.
//
// The extern "C" entry zeroes the output first where the key is split
// (cudaMemsetAsync, not a kernel) and returns cudaGetLastError() after its
// launch; the Python wrapper raises if it is not 0.  Its switch is the one
// list of the digit plans built; for any other it launches nothing and
// returns kNoPlan, which the wrapper raises as a ValueError.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "launch_once.cuh"
#include "py_entries.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;        // stages of the ring
constexpr int kChunk = 16;        // coefficients a stage
constexpr int kStepBytes = 1024;  // a column group's k-step: 4 limbs x 32 k x 8 columns

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// d += a (16 x 32 u8, row) * b (32 x 8 s8, col), s32 accumulation
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four words of u as byte planes: p[b] holds byte b of u.x, u.y, u.z,
// u.w in its bytes 0..3 (eight byte permutes)
__device__ __forceinline__ void byte_planes(const uint4& u, uint32_t (&p)[4]) {
  const uint32_t xy01 = __byte_perm(u.x, u.y, 0x5140), xy23 = __byte_perm(u.x, u.y, 0x7362);
  const uint32_t zw01 = __byte_perm(u.z, u.w, 0x5140), zw23 = __byte_perm(u.z, u.w, 0x7362);
  p[0] = __byte_perm(xy01, zw01, 0x5410);
  p[1] = __byte_perm(xy01, zw01, 0x7632);
  p[2] = __byte_perm(xy23, zw23, 0x5410);
  p[3] = __byte_perm(xy23, zw23, 0x7632);
}

// Level l's digits (u_i >> (32 - (l + 1) BB)) & (2^BB - 1) of the four
// words whose byte planes are p, one a byte (u.x's in byte 0); 0 for a
// padded level (l >= T).  A digit inside one byte is a shift and a mask of
// its plane (the bits a shift brings in from the next byte lie above the
// mask); one across two bytes takes its high bits from the next plane.
template <int BB, int T, int L>
__device__ __forceinline__ uint32_t level_digits(const uint32_t (&p)[4]) {
  if constexpr (L >= T) {
    return 0u;
  } else {
    constexpr int s = 32 - (L + 1) * BB, b = s / 8, r = s % 8;
    constexpr uint32_t mask = (1u << BB) - 1u, ones = 0x01010101u;
    if constexpr (r + BB <= 8) {
      return (p[b] >> r) & (mask * ones);
    } else {
      constexpr uint32_t lo = (0xFFu >> r) & mask, hi = mask & ~lo;
      return ((p[b] >> r) & (lo * ones)) | ((p[b + 1] << (8 - r)) & (hi * ones));
    }
  }
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, each i a constant
template <int N, int I = 0, class F>
__device__ __forceinline__ void unrolled(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    unrolled<N, I + 1>(f);
  }
}

struct Args {
  const int32_t* a;        // [B, N]
  const uint8_t* key;      // [groups, steps, 1024]
  const int32_t* b;        // b_n, element b * b_stride
  long long b_stride;
  uint32_t* out;           // [B, n1]
  int B, N, n1, groups, steps;
  uint32_t prec;           // the digits' rounding offset
  int per_split;           // chunks of 16 coefficients a split
  int atomic;              // the key is split: add into a zeroed output
};

template <int MT, int CG, int T>
struct Tile {
  static constexpr int kRows = 16 * MT * kWarps;  // ciphertexts a block
  static constexpr int kRowBytes = 4 * kChunk;    // a row's mask words in a stage
  static constexpr int kSteps = (T + 1) / 2;      // k-steps a chunk
  static constexpr int kStage = kRows * kRowBytes + CG * kSteps * kStepBytes;
};

template <int BB, int T, int K>
__device__ __forceinline__ void step_fragments(uint32_t (&a)[4], const uint32_t (&lo)[4],
                                               const uint32_t (&hi)[4]) {
  a[0] = level_digits<BB, T, 2 * K>(lo);      // row g, k 4 tq ..: level 2K
  a[1] = level_digits<BB, T, 2 * K>(hi);      // row g + 8
  a[2] = level_digits<BB, T, 2 * K + 1>(lo);  // row g, k 16 + 4 tq ..: level 2K + 1
  a[3] = level_digits<BB, T, 2 * K + 1>(hi);
}

// Block (x, y, z): column groups [CG x, CG x + CG), chunks [per_split y,
// per_split (y + 1)), rows [kRows z, kRows z + kRows); digits of BB bits,
// T levels.
template <int MT, int CG, int BB, int T>
__global__ void __launch_bounds__(kThreads, 1) key_switch_kernel(const Args args) {
  using Tl = Tile<MT, CG, T>;
  constexpr int p2 = Tl::kSteps;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  constexpr int stage = Tl::kStage;
  const int c0 = blockIdx.y * args.per_split;
  const int chunks = args.N / kChunk;
  const int nc = (c0 + args.per_split < chunks ? c0 + args.per_split : chunks) - c0;
  const int b0 = blockIdx.z * Tl::kRows, g0 = blockIdx.x * CG;

  // chunk c0 + i into slot i % kStages: rows past B and groups past the
  // key's read as zeros
  auto load = [&](int i) {
    unsigned char* st = smem + (i % kStages) * stage;
    const int c = c0 + i;
    int32_t* su = reinterpret_cast<int32_t*>(st);
    for (int e = tid; e < Tl::kRows * 4; e += kThreads) {
      const int r = e >> 2, q = e & 3;
      const bool ok = b0 + r < args.B;
      const int32_t* src =
          args.a + static_cast<size_t>(ok ? b0 + r : 0) * args.N + c * kChunk + 4 * q;
      cp_async16(su + r * kChunk + 4 * q, src, ok);
    }
    unsigned char* sk = st + Tl::kRows * Tl::kRowBytes;
    const int run = p2 * (kStepBytes / 16);  // 16-byte pieces of a group's stage
    for (int e = tid; e < CG * run; e += kThreads) {
      const int j = e / run, w = e - j * run;
      const bool ok = g0 + j < args.groups;
      const uint8_t* src =
          args.key +
          (static_cast<size_t>(ok ? g0 + j : 0) * args.steps + static_cast<size_t>(c) * p2) *
              kStepBytes +
          16 * w;
      cp_async16(sk + j * p2 * kStepBytes + 16 * w, src, ok);
    }
    cp_async_commit();
  };

  const int wrow = warp * 16 * MT;  // this warp's first row in the block
  const bool active = b0 + wrow < args.B;
  int acc[MT][CG][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][i][e] = 0;

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nc)
      load(i);
    else
      cp_async_commit();  // an empty group keeps the count of pending groups
  }
  for (int i = 0; i < nc; ++i) {
    // chunk i has landed (this thread's copies); the barrier publishes it,
    // and every warp is done with chunk i - 1, whose slot the next load takes
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < nc)
      load(i + kStages - 1);
    else
      cp_async_commit();
    if (!active) continue;
    const unsigned char* st = smem + (i % kStages) * stage;
    const int32_t* su = reinterpret_cast<const int32_t*>(st);
    const unsigned char* sk = st + Tl::kRows * Tl::kRowBytes + 16 * lane;
    // this lane's mask words: rows g and g + 8 of each m-tile, coefficients
    // 4 tq .. 4 tq + 3 of the chunk, offset for the digits' rounding, as
    // byte planes
    uint32_t lo[MT][4], hi[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = wrow + 16 * m + g;
      uint4 x = *reinterpret_cast<const uint4*>(su + r * kChunk + 4 * tq);
      uint4 y = *reinterpret_cast<const uint4*>(su + (r + 8) * kChunk + 4 * tq);
      x.x += args.prec; x.y += args.prec; x.z += args.prec; x.w += args.prec;
      y.x += args.prec; y.y += args.prec; y.z += args.prec; y.w += args.prec;
      byte_planes(x, lo[m]);
      byte_planes(y, hi[m]);
    }
    // k-step p: k 0-15 level 2p, k 16-31 level 2p + 1 (a padded level past
    // T meets zero key rows and gets zero digits)
    unrolled<p2>([&](auto P) {
      constexpr int p = decltype(P)::value;
      uint32_t af[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) step_fragments<BB, T, p>(af[m], lo[m], hi[m]);
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const unsigned char* kb = sk + (j * p2 + p) * kStepBytes;
        const uint4 k01 = *reinterpret_cast<const uint4*>(kb);
        const uint4 k23 = *reinterpret_cast<const uint4*>(kb + kStepBytes / 2);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(acc[m][j][0], af[m], k01.x, k01.y);
          mma(acc[m][j][1], af[m], k01.z, k01.w);
          mma(acc[m][j][2], af[m], k23.x, k23.y);
          mma(acc[m][j][3], af[m], k23.z, k23.w);
        }
      }
    });
  }
  if (!active) return;
  // acc[m][j][i][e]: limb i of row 16 m + g + 8 (e / 2) of this warp's,
  // column 8 j + 2 tq + e % 2 of the block's
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = b0 + wrow + 16 * m + g + 8 * (e >> 1);
        const int col = 8 * (g0 + j) + 2 * tq + (e & 1);
        if (r >= args.B || col >= args.n1) continue;
        const uint32_t v = static_cast<uint32_t>(acc[m][j][0][e]) +
                           (static_cast<uint32_t>(acc[m][j][1][e]) << 8) +
                           (static_cast<uint32_t>(acc[m][j][2][e]) << 16) +
                           (static_cast<uint32_t>(acc[m][j][3][e]) << 24);
        uint32_t val = 0u - v;
        if (col == args.n1 - 1 && blockIdx.y == 0)
          val += static_cast<uint32_t>(args.b[static_cast<long long>(r) * args.b_stride]);
        uint32_t* o = args.out + static_cast<size_t>(r) * args.n1 + col;
        if (args.atomic)
          atomicAdd(o, val);
        else
          *o = val;
      }
}

template <int MT, int CG, int BB, int T>
cudaError_t launch(const Args& a, int splits, cudaStream_t stream) {
  using Tl = Tile<MT, CG, T>;
  const size_t bytes = static_cast<size_t>(kStages) * Tl::kStage;
  static redsec::PerDevice smem;  // the opt-in, once a device (launch_once.cuh)
  cudaError_t err = redsec::opt_in_smem(smem, key_switch_kernel<MT, CG, BB, T>, bytes);
  if (err != cudaSuccess) return err;
  const long long tiles_b = (a.B + Tl::kRows - 1) / Tl::kRows;
  if (tiles_b > 65535) return cudaErrorInvalidValue;
  if (a.atomic) {
    err = cudaMemsetAsync(a.out, 0, static_cast<size_t>(a.B) * a.n1 * 4, stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.groups + CG - 1) / CG, splits, static_cast<unsigned>(tiles_b));
  key_switch_kernel<MT, CG, BB, T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// the instances of one digit plan (BB bits x T levels)
template <int BB, int T>
cudaError_t launch_mt(int mt, const Args& a, int splits, cudaStream_t stream) {
  switch (mt) {
    case 4: return launch<4, 2, BB, T>(a, splits, stream);
    case 2: return launch<2, 4, BB, T>(a, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// redsec_key_switch's answer for a digit plan with no instance
// (kernels.py::KS_NO_PLAN)
constexpr int kNoPlan = -2;

extern "C" {

// out[B, n1] = -(the digits of a [B, N] x the key) + b_n in column n1 - 1
// (see the top).  key: int8 [ceil(n1 / 8), (N / 16) ceil(t / 2), 1024]
// (kernels.py::ksk_tiles); b_n: element i at b + i b_stride; mt: 16 mt rows a
// warp (4: 512 rows a block and 2 column groups; 2: 256 rows and 4 groups);
// splits: the key's rows in that many parts (fewer where the chunks do not
// give each part one).  Every pointer 16-byte aligned but b's.
int redsec_key_switch(const int32_t* a, const int8_t* key, const int32_t* b, long long b_stride,
                      int32_t* out, int B, int N, int n1, int t, int basebit, uint32_t prec,
                      int mt, int splits, cudaStream_t stream) {
  if (B <= 0 || N < kChunk || N % kChunk != 0 || n1 <= 0 || t <= 0 || basebit <= 0 ||
      basebit > 7 || t * basebit > 32 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = N / kChunk;
  const int per_split = (chunks + splits - 1) / splits;
  const int parts = (chunks + per_split - 1) / per_split;
  if (parts > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{a,      reinterpret_cast<const uint8_t*>(key), b, b_stride,
                  reinterpret_cast<uint32_t*>(out), B, N, n1, (n1 + 7) / 8,
                  chunks * ((t + 1) / 2), prec, per_split, parts > 1 ? 1 : 0};
  // the digit plans (bits x levels) of crypto/params.py, then those of the
  // noise-budget experiments (scripts/validate_noise_budget.py)
  switch (basebit * 100 + t) {
    case 309: return static_cast<int>(launch_mt<3, 9>(mt, args, parts, stream));
    case 118: return static_cast<int>(launch_mt<1, 18>(mt, args, parts, stream));
    case 216: return static_cast<int>(launch_mt<2, 16>(mt, args, parts, stream));
    case 408: return static_cast<int>(launch_mt<4, 8>(mt, args, parts, stream));
    case 306: return static_cast<int>(launch_mt<3, 6>(mt, args, parts, stream));
    case 307: return static_cast<int>(launch_mt<3, 7>(mt, args, parts, stream));
    default: return kNoPlan;
  }
}

}  // extern "C"

// the library's Python module (py_entries.cuh)
REDSEC_PY_MODULE(key_switch, REDSEC_PY_LAUNCH(redsec_key_switch))
