// A layout check of the int8 wgmma that S1 (csrc/schoolbook.cu) issues on
// Hopper (sm_90a), a Python module of one C entry (py_entries.cuh) loaded by its test
// (tests/test_torch_cuda.py::test_wgmma_layouts_hold_on_the_card).  No TPU
// kernel is replaced.
//
// wgmma_check<N>: one warpgroup, one wgmma m64nNk32 u8.s8 -> s32 on given A
// [64][32] u8 (registers, in the m16n8k32 fragment layout of each warp's 16
// rows) and B [N][32] s8 (K-major, shared memory), written out as the
// accumulator layout S1 assumes reads it, so that a host product can confirm
// both layouts and the descriptor.  B is staged as 8-row x 16-byte core
// matrices, core (n / 8, k / 16) at (n / 8) * ng_stride + (k / 16) *
// kc_stride bytes; the descriptor carries lbo and sbo as given and layout
// type 0 (no swizzle).
//
// The extern "C" entry returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "py_entries.cuh"

namespace {

__device__ __forceinline__ void wgmma(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo_bytes, int sbo_bytes) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32);
}

template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__global__ void wgmma_check(const uint8_t* A, const int8_t* B, int* out, int kc_stride,
                            int ng_stride, int lbo, int sbo) {
  __shared__ __align__(128) unsigned char sb[8192];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  for (int i = tid; i < N * 32; i += blockDim.x) {
    const int n = i / 32, k = i % 32;
    sb[(n / 8) * ng_stride + (k / 16) * kc_stride + (n % 8) * 16 + k % 16] =
        static_cast<unsigned char>(B[i]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  auto word = [&](int row, int col) {
    const uint8_t* p = A + row * 32 + col;
    return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
           static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
  };
  const int r0 = 16 * w + g;
  const uint32_t a[4] = {word(r0, 4 * t), word(r0 + 8, 4 * t), word(r0, 16 + 4 * t),
                         word(r0 + 8, 16 + 4 * t)};
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma(acc, a, smem_desc(sb, lbo, sbo));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int j = i / 4, e = i % 4;
    out[(r0 + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] = acc[i];
  }
}

}  // namespace

extern "C" {

// A [64][32] u8, B [n][32] s8, out [64][n] int32 for n 32 or 64; strides in
// bytes (multiples of 16, the staged cores inside 8 KB)
int redsec_wgmma_check(int n, const uint8_t* A, const int8_t* B, int* out, int kc_stride,
                       int ng_stride, int lbo, int sbo, cudaStream_t stream) {
  switch (n) {
    case 32: wgmma_check<32><<<1, 128, 0, stream>>>(A, B, out, kc_stride, ng_stride, lbo, sbo); break;
    case 64: wgmma_check<64><<<1, 128, 0, stream>>>(A, B, out, kc_stride, ng_stride, lbo, sbo); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// the library's Python module (py_entries.cuh)
REDSEC_PY_MODULE(wgmma_check, REDSEC_PY_LAUNCH(redsec_wgmma_check))
