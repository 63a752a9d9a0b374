// Rotation and Toeplitz probe kernels for Hopper (sm_90a), a Python module of
// C entries (py_entries.cuh) under redsec_tpu_torch/crypto/probe_kernels.py.
// They serve the port's microbenchmarks (redsec_tpu_torch/scripts/
// bench_rotate.py and bench_schoolbook.py); no model path launches them.
//
// Each replaces a Pallas TPU kernel of the JAX package's bench scripts and
// computes the same function (outputs bit-identical), not the same blocks:
//
//   rotate_rows_kernel    <- scripts/bench_rotate.py::_mk_pallas_grid
//   rotate_tile_kernel    <- scripts/bench_rotate.py::_mk_pallas_tile
//   toeplitz_tile_kernel  <- scripts/bench_schoolbook.py::main.toep
//
// The rotation is the negacyclic X^t of a [B, 2, N] accumulator with one
// exponent per batch row: out[b, c, k] = ext[b, c, (k - t[b]) mod 2N] with
// ext = [x, -x].  The TPU kernels build ext in VMEM and roll it by a scalar
// read from SMEM (pltpu.roll); here every output element indexes its source
// directly and takes its sign from which half of ext it falls in, so ext is
// never formed.  -x is taken on uint32 (INT32_MIN must wrap; signed overflow
// is undefined in C++), and (k - t) is brought into [0, 2N) before any `%`
// could see a negative value.  Any int32 t is accepted and acts as t mod 2N.
//
// rotate_rows: one block per batch row, as the TPU grid has one program per
// row; stores are coalesced (thread k writes element k), loads are coalesced
// up to the row's shift.  rotate_tile: the batch is cut into tiles of T rows
// (a launch argument) as the TPU kernel's grid; a block stages its rows'
// exponents in shared memory and loops over the rows, as the TPU kernel's
// fori_loop.  One block a tile leaves the card empty (8 blocks at T = 64, 2
// at T = 256 for 132 SMs), so the grid's second dimension deals a tile's rows
// out over S blocks (block (i, s) takes rows s, s + S, ... of tile i), with S
// chosen at launch so that there are at least two blocks an SM.  Each thread
// writes four neighbouring outputs as one 16-byte store where N is a
// multiple of 4; their sources are neighbours too, up to the wrap at N.
//
// The Toeplitz probe expands one doubled key row w[256] into the tile
// out[j, k] = w[(127 + k - j) mod 256] (the TPU's strided roll: row j rolled
// by 129 + j, first 128 lanes kept): one launch, one element per thread.
//
// Bound on this card: bytes.  A rotation reads and writes B*2*N int32 once
// (8 MiB at B = 512, N = 1024: 2.5 us at 3.35 TB/s) with two integer
// operations an element; the Toeplitz tile moves 65 KB, far under the fixed
// cost of a launch.
//
// Each extern "C" entry returns cudaGetLastError() after its launch; the
// Python wrapper raises if it is not 0.  The SM count is read once a device
// (launch_once.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_once.cuh"
#include "py_entries.cuh"

namespace {

constexpr int kRotateThreads = 256;
constexpr int kToeplitzTile = 128;

// One row: out[c][k] = +-x[c][(k - t) mod N], c = 0, 1, for this block's
// threads striding over k.  tm = t mod 2N in [0, 2N).
__device__ __forceinline__ void rotate_row(const uint32_t* __restrict__ x,
                                           uint32_t* __restrict__ out, int tm, int N) {
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    int src = k - tm;  // in (-2N, N)
    if (src < 0) src += 2 * N;
    const bool neg = src >= N;
    const int j = neg ? src - N : src;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t v = x[c * N + j];
      out[c * N + k] = neg ? 0u - v : v;
    }
  }
}

__device__ __forceinline__ int mod_2n(int t, int N) {
  int tm = t % (2 * N);
  return tm < 0 ? tm + 2 * N : tm;
}

__global__ void rotate_rows_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ t,
                                   uint32_t* __restrict__ out, int N) {
  const long long row = static_cast<long long>(blockIdx.x) * 2 * N;
  rotate_row(x + row, out + row, mod_2n(t[blockIdx.x], N), N);
}

// Four outputs k .. k + 3 of one row as one 16-byte store.
__device__ __forceinline__ void rotate_row4(const uint32_t* __restrict__ x,
                                            uint32_t* __restrict__ out, int tm, int N) {
  for (int k = 4 * threadIdx.x; k < N; k += 4 * blockDim.x) {
    uint32_t v[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int src = k + e - tm;  // in (-2N, N)
      if (src < 0) src += 2 * N;
      const bool neg = src >= N;
      const int j = neg ? src - N : src;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t w = x[c * N + j];
        v[c][e] = neg ? 0u - w : w;
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
      *reinterpret_cast<uint4*>(out + c * N + k) = make_uint4(v[c][0], v[c][1], v[c][2], v[c][3]);
  }
}

// Block (i, s) of a (B / T, S) grid: rows s, s + S, ... of tile i.
__global__ void rotate_tile_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ t,
                                   uint32_t* __restrict__ out, int N, int T) {
  extern __shared__ int ts[];  // this block's exponents, ceil(T / S) ints
  const int S = gridDim.y, s = blockIdx.y;
  const long long first = static_cast<long long>(blockIdx.x) * T;
  const int mine = (T - s + S - 1) / S;  // rows of the tile that fall to this block
  for (int r = threadIdx.x; r < mine; r += blockDim.x) ts[r] = mod_2n(t[first + s + r * S], N);
  __syncthreads();
  for (int r = 0; r < mine; ++r) {
    const long long row = (first + s + r * S) * 2 * N;
    if (N % 4 == 0)
      rotate_row4(x + row, out + row, ts[r], N);
    else
      rotate_row(x + row, out + row, ts[r], N);
  }
}

__global__ void toeplitz_tile_kernel(const int32_t* __restrict__ w, int32_t* __restrict__ out) {
  const int j = blockIdx.x, k = threadIdx.x;
  out[j * kToeplitzTile + k] = w[(kToeplitzTile - 1 + k - j) & (2 * kToeplitzTile - 1)];
}

}  // namespace

extern "C" {

// K5: out[B, 2, N] = X^t[b] * x[b] (negacyclic), one block per row.
int redsec_rotate_rows(const int32_t* x, const int32_t* t, int32_t* out, int B, int N,
                       cudaStream_t stream) {
  if (B <= 0 || N <= 0 || N > (1 << 29)) return static_cast<int>(cudaErrorInvalidValue);
  rotate_rows_kernel<<<B, kRotateThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(x), t, reinterpret_cast<uint32_t*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

// K6: the same function by tiles of T rows, each tile's rows dealt out over S
// blocks; B must be a multiple of T.
int redsec_rotate_tile(const int32_t* x, const int32_t* t, int32_t* out, int B, int N, int T,
                       cudaStream_t stream) {
  if (B <= 0 || N <= 0 || N > (1 << 29) || T <= 0 || B % T != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = redsec::sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = B / T;
  int S = (2 * sms + tiles - 1) / tiles;  // at least two blocks an SM, at most one a row
  S = S > T ? T : S;
  const size_t bytes = sizeof(int) * ((T + S - 1) / S);
  if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  rotate_tile_kernel<<<dim3(tiles, S), kRotateThreads, bytes, stream>>>(
      reinterpret_cast<const uint32_t*>(x), t, reinterpret_cast<uint32_t*>(out), N, T);
  return static_cast<int>(cudaGetLastError());
}

// K7: out[128, 128] = Toeplitz tile of w[256].
int redsec_toeplitz_tile(const int32_t* w, int32_t* out, cudaStream_t stream) {
  toeplitz_tile_kernel<<<kToeplitzTile, kToeplitzTile, 0, stream>>>(w, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// the library's Python module (py_entries.cuh)
REDSEC_PY_MODULE(probes, REDSEC_PY_LAUNCH(redsec_rotate_rows),
                 REDSEC_PY_LAUNCH(redsec_rotate_tile),
                 REDSEC_PY_LAUNCH(redsec_toeplitz_tile))
