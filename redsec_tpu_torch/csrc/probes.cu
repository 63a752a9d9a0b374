// Rotation and Toeplitz probe kernels for Hopper (sm_90a), bound to PyTorch
// with ctypes (redsec_tpu_torch/crypto/probe_kernels.py).  They serve the
// port's microbenchmarks (redsec_tpu_torch/scripts/bench_rotate.py and
// bench_schoolbook.py); no model path launches them.
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
// row.  rotate_tile: one block per T rows with the tile's exponents staged
// in shared memory and a loop over the rows, as the TPU kernel's fori_loop;
// T is a launch argument.  Stores are coalesced (thread k writes element k);
// loads are coalesced up to the row's shift.
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
// Python wrapper raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

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

__global__ void rotate_tile_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ t,
                                   uint32_t* __restrict__ out, int N, int T) {
  extern __shared__ int ts[];  // the tile's exponents, T ints
  const long long first = static_cast<long long>(blockIdx.x) * T;
  for (int r = threadIdx.x; r < T; r += blockDim.x) ts[r] = mod_2n(t[first + r], N);
  __syncthreads();
  for (int r = 0; r < T; ++r) {
    const long long row = (first + r) * 2 * N;
    rotate_row(x + row, out + row, ts[r], N);
  }
}

__global__ void toeplitz_tile_kernel(const int32_t* __restrict__ w, int32_t* __restrict__ out) {
  const int j = blockIdx.x, k = threadIdx.x;
  out[j * kToeplitzTile + k] = w[(kToeplitzTile - 1 + k - j) & (2 * kToeplitzTile - 1)];
}

}  // namespace

extern "C" {

const char* redsec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K5: out[B, 2, N] = X^t[b] * x[b] (negacyclic), one block per row.
int redsec_rotate_rows(const int32_t* x, const int32_t* t, int32_t* out, int B, int N,
                       cudaStream_t stream) {
  if (B <= 0 || N <= 0 || N > (1 << 29)) return static_cast<int>(cudaErrorInvalidValue);
  rotate_rows_kernel<<<B, kRotateThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(x), t, reinterpret_cast<uint32_t*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

// K6: the same function, one block per tile of T rows; B must be a multiple of T.
int redsec_rotate_tile(const int32_t* x, const int32_t* t, int32_t* out, int B, int N, int T,
                       cudaStream_t stream) {
  if (B <= 0 || N <= 0 || N > (1 << 29) || T <= 0 || B % T != 0 || T > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  rotate_tile_kernel<<<B / T, kRotateThreads, T * sizeof(int), stream>>>(
      reinterpret_cast<const uint32_t*>(x), t, reinterpret_cast<uint32_t*>(out), N, T);
  return static_cast<int>(cudaGetLastError());
}

// K7: out[128, 128] = Toeplitz tile of w[256].
int redsec_toeplitz_tile(const int32_t* w, int32_t* out, cudaStream_t stream) {
  toeplitz_tile_kernel<<<kToeplitzTile, kToeplitzTile, 0, stream>>>(w, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
