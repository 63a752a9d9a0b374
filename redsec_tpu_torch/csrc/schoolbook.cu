// The schoolbook external product (S1) for Hopper (sm_90a), bound to PyTorch
// with ctypes (redsec_tpu_torch/crypto/kernels.py::schoolbook_product).
//
// It is one CMUX round's external product for the parameter sets without
// NTT primes (N >= 4096: medium, large, medium_v2, large_v2), and for any
// set when the NTT plan is switched off:
//
//   delta[b, u] = sum_r digits[b, r] * bk[r, u]   in Z[X]/(X^N + 1), mod 2^32
//
// digits int32 [B, rows, N] (signed gadget digits of the round's difference),
// bk int32 [rows, 2, N] (one round of the raw bootstrapping key, shared by the
// whole batch), delta int32 [B, 2, N].
//
// What it replaces: no Pallas kernel.  The JAX package runs this product as
// one XLA int8 convolution a round (redsec_tpu/crypto/bootstrap.py:538,
// external_delta_schoolbook, jax.lax.conv_general_dilated with int32
// accumulation over 8-bit limbs of the key and of the digits); its TPU probe
// of the product's Toeplitz tile was scripts/bench_schoolbook.py:254 (K7).
// The output is the same exact negacyclic product, so it is bit-identical.
//
// Design.  As a matrix product, delta[:, u] = D_r @ T(bk[r, u]) summed over
// r, with T the negacyclic Toeplitz matrix T[j, k] = ext(k - j), ext(m) =
// bk[m] for m >= 0 and -bk[m + N] for m < 0.  A block computes a tile of 16*BT
// ciphertexts x 128 output coefficients of one u, and walks the contraction
// (rows x N taps) in steps of 32 taps: each step stages the digits tile
// [32 taps][16*BT ciphertexts] and the 159 values of ext the tile needs (the
// Toeplitz tile is never formed) in shared memory.  A thread keeps BT x 8
// accumulators (BT ciphertexts, 8 neighbouring coefficients).  Along the taps
// its 8 key values slide by one place, so each tap costs one new key value,
// BT digits and 8*BT multiply-adds.  All arithmetic is uint32: the product
// is exact mod 2^32 by wraparound (signed overflow would be undefined), so
// no limbs are needed on the CUDA cores, unlike the int8 formulation.
//
// Bound on this card: operations.  2 * rows * N^2 int32 multiply-adds per
// ciphertext and round (2.68e8 at medium_v2): 16.75e12 a second on the CUDA
// cores gives 8.2 ms a 512-batch at N = 4096, rows 8.  The int8 tensor cores
// would bound the JAX package's limb formulation at 8 * 8 * N^2 MACs / 989.5e12
// a second (1.1 ms); that design (Toeplitz tiles on mma) is later work.  The
// key row and the digits are re-read from L2 by each of the N/128 x 2 blocks
// that need them (a few GB a 512-batch, well under the time of the MACs).
//
// The extern "C" entry returns cudaGetLastError() after its launch; the
// Python wrapper raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 ciphertext lanes x 16 coefficient lanes
constexpr int kTileK = 128;    // output coefficients a block: 16 lanes x 8
constexpr int kTaps = 32;      // taps a step

// Block (kt, bt, u): coefficients [128 kt, 128 kt + 128) of delta[b, u] for
// ciphertexts [16 BT bt, 16 BT bt + 16 BT).
template <int BT>
__global__ void __launch_bounds__(kThreads, 2)
schoolbook_kernel(const uint32_t* __restrict__ digits, const uint32_t* __restrict__ bk,
                  uint32_t* __restrict__ out, int B, int rows, int N) {
  constexpr int TB = 16 * BT;
  // digits tile, transposed ([tap][ciphertext]); the row pad of one word
  // spreads the transposing stores over all banks
  __shared__ uint32_t sd[kTaps][TB + 1];
  __shared__ uint32_t sw[kTileK + kTaps];  // ext(m) for m = m0 .. m0 + 158
  const int tid = threadIdx.x, tk = tid & 15, tb = tid >> 4;
  const int k0 = blockIdx.x * kTileK, b0 = blockIdx.y * TB, u = blockIdx.z;

  uint32_t acc[BT][8];
#pragma unroll
  for (int i = 0; i < BT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0u;

  for (int r = 0; r < rows; ++r) {
    const uint32_t* bkr = bk + (static_cast<size_t>(r) * 2 + u) * N;
    for (int j0 = 0; j0 < N; j0 += kTaps) {
      // digits[b0 + b, r, j0 .. j0 + 31] as 16-byte loads: a warp reads four
      // ciphertexts' 128-byte runs; ciphertexts past B read as 0
      for (int e = tid; e < TB * (kTaps / 4); e += kThreads) {
        const int q = e & (kTaps / 4 - 1), b = e / (kTaps / 4);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (b0 + b < B)
          v = *reinterpret_cast<const uint4*>(
              digits + (static_cast<size_t>(b0 + b) * rows + r) * N + j0 + 4 * q);
        sd[4 * q + 0][b] = v.x;
        sd[4 * q + 1][b] = v.y;
        sd[4 * q + 2][b] = v.z;
        sd[4 * q + 3][b] = v.w;
      }
      // m = k - j over the tile lies in [m0, m0 + 158], inside (-N, N)
      const int m0 = k0 - j0 - (kTaps - 1);
      for (int w = tid; w < kTileK + kTaps - 1; w += kThreads) {
        const int m = m0 + w;
        sw[w] = m >= 0 ? bkr[m] : 0u - bkr[m + N];
      }
      __syncthreads();
      // coefficient k = k0 + 8 tk + c against tap j = j0 + jj reads
      // sw[8 tk + c - jj + 31]: one new value a tap, the rest slide up
      uint32_t win[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) win[c] = sw[8 * tk + c + kTaps - 1];
#pragma unroll
      for (int jj = 0; jj < kTaps; ++jj) {
        if (jj > 0) {
#pragma unroll
          for (int c = 7; c > 0; --c) win[c] = win[c - 1];
          win[0] = sw[8 * tk + kTaps - 1 - jj];
        }
#pragma unroll
        for (int i = 0; i < BT; ++i) {
          const uint32_t d = sd[jj][tb * BT + i];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] += d * win[c];
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < BT; ++i) {
    const int b = b0 + tb * BT + i;
    if (b < B) {
      uint4* dst = reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * 2 + u) * N + k0 +
                                            8 * tk);
      dst[0] = make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      dst[1] = make_uint4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <int BT>
cudaError_t launch(const uint32_t* digits, const uint32_t* bk, uint32_t* out, int B, int rows,
                   int N, cudaStream_t stream) {
  const dim3 grid(N / kTileK, (B + 16 * BT - 1) / (16 * BT), 2);
  schoolbook_kernel<BT><<<grid, kThreads, 0, stream>>>(digits, bk, out, B, rows, N);
  return cudaGetLastError();
}

// Ciphertexts a thread: 8 (a tile of 128) where the batch fills tiles, else
// the fewest that cover the batch in one tile, so that a small batch (a gate,
// a reduced-n check) does not pay for 128 ciphertexts.
int tile_ciphertexts(int B) {
  if (B <= 16) return 1;
  if (B <= 32) return 2;
  if (B <= 64) return 4;
  return 8;
}

}  // namespace

extern "C" {

const char* redsec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// S1: delta[B, 2, N] = sum_r digits[B, r] * bk[r, u] (negacyclic, mod 2^32).
// N a multiple of 128 (the wrapper passes 256 .. 8192), rows >= 1, every
// pointer 16-byte aligned.
int redsec_schoolbook_product(const int32_t* digits, const int32_t* bk, int32_t* out, int B,
                              int rows, int N, cudaStream_t stream) {
  if (B <= 0 || rows <= 0 || N < kTileK || N % kTileK != 0 || N > (1 << 16) ||
      B > 65535 * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = reinterpret_cast<const uint32_t*>(digits);
  const auto* k = reinterpret_cast<const uint32_t*>(bk);
  auto* o = reinterpret_cast<uint32_t*>(out);
  switch (tile_ciphertexts(B)) {
    case 1: return static_cast<int>(launch<1>(d, k, o, B, rows, N, stream));
    case 2: return static_cast<int>(launch<2>(d, k, o, B, rows, N, stream));
    case 4: return static_cast<int>(launch<4>(d, k, o, B, rows, N, stream));
    default: return static_cast<int>(launch<8>(d, k, o, B, rows, N, stream));
  }
}

}  // extern "C"
