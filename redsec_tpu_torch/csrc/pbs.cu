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
// Design.  One thread block owns one ciphertext (N/2 threads; each thread
// owns coefficients tid and tid + N/2 and does one butterfly per NTT stage).
// The TPU kernels' 128-point four-step DFTs exist for the MXU; on CUDA cores a
// radix-2 butterfly NTT needs ~25x fewer mulmods, so the BK is prepared in the
// radix-2 bit-reversed order of ntt.ntt_device (flavour "radix2") and the
// same butterflies run here.  The PBS output is the exact negacyclic product
// mod 2^32 whatever the transform, so outputs match the JAX package bit for
// bit.  Torus arithmetic is uint32 (signed overflow is undefined in C++);
// residues are < p < 2^15 so every product fits 32 bits and a Barrett
// reduction (umulhi by floor(2^32/p), one correction) is exact.
//
// blind_rotate loops over all n rounds inside the block (the TPU's sequential
// grid axis has no Hopper counterpart): the accumulator stays in shared
// memory, round j's exponent is a plain load from abar, the rotation indexes
// directly (out[k] = +-acc[(k - t) mod N]), and round j's BK slice is read
// from global memory.  Per round and prime each block runs `rows` forward
// NTTs (one digit polynomial at a time, MAC'd into 8 register accumulators
// with a reduction per product), 8 inverse NTTs, and a 2-prime Garner CRT in
// int64.  Shared memory: acc 2N u32 + one NTT buffer N u32 + prime-0
// residues 8N u16 = 28 KB at N = 1024.
//
// Bound on this card: int32 operations.  The prepared BK is P * n * rows *
// 8 * N * 2 B = 137.6 MB at small_v2_tpu, 41 us at 3.35 TB/s, while one
// ciphertext's n rounds of transforms and MAC are ~0.4 G modular ops
// (chip_smoke.py counts both).  This first version is latency-bound well
// above that: one block a ciphertext, one barrier per butterfly stage, and
// ~105 registers a thread, so one 512-thread block per SM (PERF.md).  Every
// block streams the whole BK through L2; several ciphertexts per block
// would reuse each slice.
//
// Each extern "C" entry returns cudaGetLastError() after its launch; the
// Python wrapper raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Mod {
  uint32_t p;
  uint32_t m;  // floor(2^32 / p)
};

__device__ __forceinline__ Mod make_mod(uint32_t p) {
  Mod r;
  r.p = p;
  r.m = static_cast<uint32_t>(0x100000000ull / p);
  return r;
}

// x mod p for any uint32 x: the umulhi quotient is floor(x/p) or one less.
__device__ __forceinline__ uint32_t reduce(uint32_t x, Mod md) {
  uint32_t q = __umulhi(x, md.m);
  uint32_t r = x - q * md.p;
  return r >= md.p ? r - md.p : r;
}

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, Mod md) {
  return reduce(a * b, md);  // a, b < 2^15
}

// Tables per prime: int32 [4][N] = twist, forward stage twiddles (stage s at
// offset N - (N >> s)), untwist (psi^-j / N), inverse stage twiddles (stage s
// at offset 2^s - 1).  Same values and order as ntt.NttPlan.

// Forward negacyclic NTT of a[0..N) in shared memory (values < p), natural
// order in, bit-reversed out (decimation in frequency, = ntt.ntt_device).
template <int N>
__device__ void ntt_fwd(uint32_t* a, const int32_t* tab, Mod md) {
  const int tid = threadIdx.x;
  for (int k = tid; k < N; k += N / 2) a[k] = mulmod(a[k], tab[k], md);
  __syncthreads();
  for (int h = N / 2; h >= 1; h >>= 1) {
    const int32_t* w = tab + N + (N - 2 * h);
    const int i = tid & (h - 1);
    const int i0 = ((tid - i) << 1) + i, i1 = i0 + h;
    const uint32_t x = a[i0], y = a[i1];
    uint32_t s0 = x + y;
    s0 = s0 >= md.p ? s0 - md.p : s0;
    uint32_t d = x + md.p - y;
    d = d >= md.p ? d - md.p : d;
    a[i0] = s0;
    a[i1] = mulmod(d, w[i], md);
    __syncthreads();
  }
}

// Inverse of ntt_fwd (decimation in time, bit-reversed in, natural out, with
// the psi^-j / N untwist), = ntt.intt_device.
template <int N>
__device__ void ntt_inv(uint32_t* a, const int32_t* tab, Mod md) {
  const int tid = threadIdx.x;
  for (int h = 1; h < N; h <<= 1) {
    const int32_t* w = tab + 3 * N + (h - 1);
    const int i = tid & (h - 1);
    const int i0 = ((tid - i) << 1) + i, i1 = i0 + h;
    const uint32_t x = a[i0];
    const uint32_t t = mulmod(a[i1], w[i], md);
    uint32_t s0 = x + t;
    s0 = s0 >= md.p ? s0 - md.p : s0;
    uint32_t s1 = x + md.p - t;
    s1 = s1 >= md.p ? s1 - md.p : s1;
    a[i0] = s0;
    a[i1] = s1;
    __syncthreads();
  }
  for (int k = tid; k < N; k += N / 2) a[k] = mulmod(a[k], tab[2 * N + k], md);
  __syncthreads();
}

struct Crt {
  uint32_t p0, p1, inv01;  // inv01 = p0^-1 mod p1
  Mod m1;
};

// Signed CRT value of (c0 mod p0, c1 mod p1) as a torus32 (mod 2^32).  The
// external product is bounded by rows*N*(Bg/2)*128 < p0*p1/2.8
// (ntt.primes_for), so the exact int64 sign decision agrees with the fp32
// one of the JAX package on every reachable value.
__device__ __forceinline__ uint32_t crt2(uint32_t c0, uint32_t c1, const Crt& c) {
  uint32_t xm = reduce(c0, c.m1);
  uint32_t diff = c1 + c.p1 - xm;
  diff = diff >= c.p1 ? diff - c.p1 : diff;
  const uint32_t t1 = mulmod(diff, c.inv01, c.m1);
  long long v = static_cast<long long>(c0) + static_cast<long long>(t1) * c.p0;
  const long long P = static_cast<long long>(c.p0) * c.p1;
  if (2 * v >= P) v -= P;
  return static_cast<uint32_t>(v);
}

// One TGSW external product for this block's ciphertext:
//   delta[u] = sum_rows digit_row (x) BK[row][u]  (mod 2^32, u = 0, 1)
// digit(j, c) gives row j's signed digit at coefficient tid + c*N/2.
// bk points at the round slice of prime 0, int16 [rows][8][N] residues;
// prime 1's slice is prime_stride elements further.  On return delta[u][c]
// holds this thread's two coefficients of both output polynomials.
template <int N, class DigitFn>
__device__ __forceinline__ void external_product_block(const DigitFn& digit, int rows,
                                       const int16_t* bk, long long prime_stride,
                                       const int32_t* tabs, const Crt& crt,
                                       uint32_t* buf, uint16_t* res0,
                                       uint32_t delta[2][2]) {
  constexpr int T = N / 2;
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < 2; ++u) delta[u][0] = delta[u][1] = 0u;
  for (int pi = 0; pi < 2; ++pi) {
    const uint32_t p = pi ? crt.p1 : crt.p0;
    const Mod md = make_mod(p);
    const int32_t* tab = tabs + pi * 4 * N;
    const int16_t* bkp = bk + pi * prime_stride;
    uint32_t acc[8][2];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o][0] = acc[o][1] = 0u;
    for (int j = 0; j < rows; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = digit(j, c);
        buf[tid + c * T] = static_cast<uint32_t>(d < 0 ? d + static_cast<int>(p) : d);
      }
      ntt_fwd<N>(buf, tab, md);
      const int16_t* bkr = bkp + static_cast<long long>(j) * 8 * N;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = tid + c * T;
        const uint32_t dk = buf[k];
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const uint32_t b = static_cast<uint32_t>(static_cast<uint16_t>(bkr[o * N + k]));
          acc[o][c] = reduce(acc[o][c] + dk * b, md);  // < p + p^2 < 2^31
        }
      }
      __syncthreads();  // buf is rewritten by the next row
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      buf[tid] = acc[o][0];
      buf[tid + T] = acc[o][1];
      __syncthreads();
      ntt_inv<N>(buf, tab, md);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = tid + c * T;
        if (pi == 0) {
          res0[o * N + k] = static_cast<uint16_t>(buf[k]);
        } else {
          const uint32_t v = crt2(res0[o * N + k], buf[k], crt);
          delta[o / 4][c] += v << (8 * (o % 4));  // recombine the 4 BK limbs
        }
      }
      __syncthreads();
    }
  }
}

struct Gadget {
  int l, bg_bit;
  uint32_t offset;  // sum_j (Bg/2) * 2^(32 - (j+1)*bg_bit), as uint32
};

// diff = X^t * acc - acc for this thread's coefficients (acc in shared
// memory, t in [0, 2N)): X^t acc [k] = +-acc[(k - t) mod N], negated when
// (k - t) mod 2N >= N.
template <int N>
__device__ __forceinline__ void rotate_diff(const uint32_t* acc, int t, uint32_t diff[2][2]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int k = tid + c * (N / 2);
    int src = k - t;
    if (src < 0) src += 2 * N;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t v = src >= N ? 0u - acc[u * N + src - N] : acc[u * N + src];
      diff[u][c] = v - acc[u * N + k];
    }
  }
}

// Signed gadget digits of diff: row j = bloc * l + level.  The four diff
// values are held by value and picked with selects (a runtime index into a
// local array would put it in local memory).
struct DiffDigits {
  uint32_t d00, d01, d10, d11;  // diff[bloc][c]
  Gadget g;
  __device__ __forceinline__ int operator()(int j, int c) const {
    const int bloc = j / g.l, lv = j - bloc * g.l;
    const uint32_t x = bloc ? (c ? d11 : d10) : (c ? d01 : d00);
    const uint32_t u = x + g.offset;
    const int shift = 32 - (lv + 1) * g.bg_bit;
    return static_cast<int>((u >> shift) & ((1u << g.bg_bit) - 1u)) - (1 << (g.bg_bit - 1));
  }
};

template <int N>
struct RowDigits {
  const int32_t* d;  // [rows][N]
  __device__ __forceinline__ int operator()(int j, int c) const {
    return d[j * N + threadIdx.x + c * (N / 2)];
  }
};

// ---------------------------------------------------------------- kernels

template <int N>
__global__ void __launch_bounds__(N / 2) ntt_kernel(const int32_t* x, int32_t* y,
                                                    const int32_t* tab, uint32_t p,
                                                    int inverse) {
  __shared__ uint32_t buf[N];
  const long long row = blockIdx.x;
  const Mod md = make_mod(p);
  const int tid = threadIdx.x;
  buf[tid] = static_cast<uint32_t>(x[row * N + tid]);
  buf[tid + N / 2] = static_cast<uint32_t>(x[row * N + tid + N / 2]);
  __syncthreads();
  if (inverse)
    ntt_inv<N>(buf, tab, md);
  else
    ntt_fwd<N>(buf, tab, md);
  y[row * N + tid] = static_cast<int32_t>(buf[tid]);
  y[row * N + tid + N / 2] = static_cast<int32_t>(buf[tid + N / 2]);
}

template <int N>
__global__ void __launch_bounds__(N / 2) external_product_kernel(
    const int32_t* digits, const int16_t* bk, long long prime_stride,
    const int32_t* tabs, int32_t* delta_out, int rows, Crt crt) {
  __shared__ uint32_t buf[N];
  __shared__ uint16_t res0[8 * N];
  const long long m = blockIdx.x;
  RowDigits<N> dig{digits + m * rows * N};
  uint32_t delta[2][2];
  external_product_block<N>(dig, rows, bk, prime_stride, tabs, crt, buf, res0, delta);
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      delta_out[(m * 2 + u) * N + tid + c * (N / 2)] = static_cast<int32_t>(delta[u][c]);
}

template <int N>
__global__ void __launch_bounds__(N / 2) cmux_round_kernel(
    const int32_t* acc_in, const int32_t* t, const int16_t* bk, long long prime_stride,
    const int32_t* tabs, int32_t* acc_out, Gadget g, Crt crt) {
  __shared__ uint32_t acc[2 * N];
  __shared__ uint32_t buf[N];
  __shared__ uint16_t res0[8 * N];
  const long long m = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < 2 * N; k += N / 2) acc[k] = static_cast<uint32_t>(acc_in[m * 2 * N + k]);
  __syncthreads();
  uint32_t diff[2][2];
  rotate_diff<N>(acc, t[m], diff);
  const DiffDigits dig{diff[0][0], diff[0][1], diff[1][0], diff[1][1], g};
  uint32_t delta[2][2];
  external_product_block<N>(dig, 2 * g.l, bk, prime_stride, tabs, crt, buf, res0, delta);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = tid + c * (N / 2);
      acc_out[(m * 2 + u) * N + k] = static_cast<int32_t>(acc[u * N + k] + delta[u][c]);
    }
}

template <int N>
__global__ void __launch_bounds__(N / 2) blind_rotate_kernel(
    const int32_t* acc0, const int32_t* abar, const int16_t* bk, const int32_t* tabs,
    int32_t* acc_out, int n, Gadget g, Crt crt) {
  __shared__ uint32_t acc[2 * N];
  __shared__ uint32_t buf[N];
  __shared__ uint16_t res0[8 * N];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int rows = 2 * g.l;
  const long long round_stride = static_cast<long long>(rows) * 8 * N;
  const long long prime_stride = round_stride * n;
  for (int k = tid; k < 2 * N; k += N / 2) acc[k] = static_cast<uint32_t>(acc0[b * 2 * N + k]);
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    uint32_t diff[2][2];
    rotate_diff<N>(acc, abar[b * n + j], diff);
    const DiffDigits dig{diff[0][0], diff[0][1], diff[1][0], diff[1][1], g};
    uint32_t delta[2][2];
    // ends with __syncthreads(): every thread's rotation reads of acc are done
    external_product_block<N>(dig, rows, bk + j * round_stride, prime_stride, tabs, crt,
                              buf, res0, delta);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[u * N + tid + c * (N / 2)] += delta[u][c];
    __syncthreads();
  }
  for (int k = tid; k < 2 * N; k += N / 2) acc_out[b * 2 * N + k] = static_cast<int32_t>(acc[k]);
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
  c.inv01 = powmod(c.p0 % c.p1, c.p1 - 2, c.p1);
  c.m1.p = c.p1;
  c.m1.m = static_cast<uint32_t>(0x100000000ull / c.p1);
  return c;
}

bool primes_ok(int p0, int p1) {
  return p0 > 2 && p1 > 2 && p0 < (1 << 15) && p1 < (1 << 15) && p0 != p1;
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

// K1: y[M, N] = NTT (or inverse) of x[M, N] mod p; tab = this prime's [4][N].
int redsec_ntt(const int32_t* x, int32_t* y, const int32_t* tab, int M, int N, int p,
               int inverse, cudaStream_t stream) {
  if (M <= 0 || p <= 2 || p >= (1 << 15)) return static_cast<int>(cudaErrorInvalidValue);
  REDSEC_DISPATCH_N(N, ntt_kernel<NN><<<M, NN / 2, 0, stream>>>(
                           x, y, tab, static_cast<uint32_t>(p), inverse));
  return static_cast<int>(cudaGetLastError());
}

// K2: delta[M, 2, N] = digits[M, rows, N] (x) bk[P=2][rows][8][N] (prime
// stride prime_stride elements).
int redsec_external_product(const int32_t* digits, const int16_t* bk, long long prime_stride,
                            const int32_t* tabs, int32_t* delta, int M, int N, int rows,
                            int p0, int p1, cudaStream_t stream) {
  if (M <= 0 || rows <= 0 || !primes_ok(p0, p1)) return static_cast<int>(cudaErrorInvalidValue);
  const Crt crt = make_crt(p0, p1);
  REDSEC_DISPATCH_N(N, external_product_kernel<NN><<<M, NN / 2, 0, stream>>>(
                           digits, bk, prime_stride, tabs, delta, rows, crt));
  return static_cast<int>(cudaGetLastError());
}

// K3: acc_out[M, 2, N] = acc + ExtProd(Decomp(X^t[m] acc - acc), bk round).
int redsec_cmux_round(const int32_t* acc, const int32_t* t, const int16_t* bk,
                      long long prime_stride, const int32_t* tabs, int32_t* out, int M, int N,
                      int l, int bg_bit, uint32_t offset, int p0, int p1,
                      cudaStream_t stream) {
  if (M <= 0 || l <= 0 || bg_bit <= 0 || l * bg_bit > 32 || !primes_ok(p0, p1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Crt crt = make_crt(p0, p1);
  const Gadget g{l, bg_bit, offset};
  REDSEC_DISPATCH_N(N, cmux_round_kernel<NN><<<M, NN / 2, 0, stream>>>(
                           acc, t, bk, prime_stride, tabs, out, g, crt));
  return static_cast<int>(cudaGetLastError());
}

// K4: all n CMUX rounds; bk int16 [2][n][rows][8][N], abar int32 [B][n].
int redsec_blind_rotate(const int32_t* acc0, const int32_t* abar, const int16_t* bk,
                        const int32_t* tabs, int32_t* out, int B, int n, int N, int l,
                        int bg_bit, uint32_t offset, int p0, int p1, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || l <= 0 || bg_bit <= 0 || l * bg_bit > 32 || !primes_ok(p0, p1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Crt crt = make_crt(p0, p1);
  const Gadget g{l, bg_bit, offset};
  REDSEC_DISPATCH_N(N, blind_rotate_kernel<NN><<<B, NN / 2, 0, stream>>>(
                           acc0, abar, bk, tabs, out, n, g, crt));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
