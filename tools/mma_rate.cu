// Rate probes of the int8 tensor-core instructions S1 (in
// redsec_tpu_torch/csrc/schoolbook.cu) can use on Hopper (sm_90a), bound to
// a Python module of C entries (tools/mma_rate.py).  No TPU kernel is replaced and no
// path of the port runs these: they measure the ceiling of each instruction
// and how the tensor cores overlap other work, which chose S1's design.
//
// - mma_sync_rate: every warp issues mma.sync m16n8k32 u8.s8 -> s32 on 16
//   independent accumulators, 8 warps a block.
// - wgmma_rate<N>: two warpgroups a block issue wgmma m64nNk32 u8.s8 -> s32
//   with A from registers and B from shared memory, four a group.
// - wgmma_overlap<KIND, MMA>: how much other work a warpgroup can do between
//   issuing its wgmmas and waiting for them before the tensor cores idle.
//
// The layout check of the wgmma S1 issues is redsec_tpu_torch/csrc/wgmma_check.cu.
// Each extern "C" entry returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "py_entries.cuh"

namespace {

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_n32(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma_n64(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

__device__ __forceinline__ void wgmma(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_n32(d, a, desc);
}
__device__ __forceinline__ void wgmma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_n64(d, a, desc);
}
__device__ __forceinline__ void wgmma(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_n128(d, a, desc);
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

__global__ void __launch_bounds__(256, 1) mma_sync_rate(int iters, int* sink) {
  const uint32_t x = threadIdx.x + 1;
  const uint32_t a[4] = {x, x * 3u, x * 5u, x * 7u};
  const uint32_t b0 = x * 11u, b1 = x * 13u;
  int acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 16; ++j) mma_u8s8(acc[j], a, b0, b1);
  int s = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  if (s == 0x7EADBEEF) sink[0] = s;
}

template <int N>
__global__ void __launch_bounds__(256, 1) wgmma_rate(int iters, int* sink) {
  __shared__ __align__(128) unsigned char sb[N * 32];
  for (int i = threadIdx.x; i < N * 32; i += blockDim.x) sb[i] = static_cast<unsigned char>(i * 7);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t desc = smem_desc(sb, 128, 256);
  const uint32_t x = threadIdx.x + 1;
  const uint32_t a[4] = {x, x * 3u, x * 5u, x * 7u};
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  for (int it = 0; it < iters; ++it) {
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma(acc, a, desc);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  if (s == 0x7EADBEEF) sink[0] = s;
}

// Overlap of the tensor cores with other work, as S1's loop has it: each
// trip a warpgroup issues 8 wgmma m64n32k32 (8 accumulators, A in
// registers), commits, does `work` units of other work, then waits for the
// previous trip's group (wait_group 1).  KIND 1: a dependent chain of
// integer multiply-adds; KIND 2: independent conflict-free 4-byte shared
// loads (one shared-memory wavefront a warp each).  MMA false: the same
// loop without the wgmmas.
template <int KIND, bool MMA>
__global__ void __launch_bounds__(256, 1) wgmma_overlap(int iters, int work, int* sink) {
  __shared__ __align__(128) unsigned char sb[8 * 1024];
  __shared__ uint32_t sw[4096];
  for (int i = threadIdx.x; i < 8 * 1024; i += blockDim.x) sb[i] = static_cast<unsigned char>(i * 7);
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) sw[i] = i * 2654435761u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t desc = smem_desc(sb, 128, 256);
  const uint32_t x = threadIdx.x + 1;
  const uint32_t a[4] = {x, x * 3u, x * 5u, x * 7u};
  int acc[8][16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[j][i] = 0;
  uint32_t z = x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) fence_operands(acc[j]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (MMA) {
#pragma unroll
      for (int j = 0; j < 8; ++j) wgmma(acc[j], a, desc + ((it & 7) << 6));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (KIND == 1) {
      for (int k = 0; k < work; ++k) z = z * 1664525u + 1013904223u;
    } else {
#pragma unroll 16
      for (int k = 0; k < work; ++k) z += sw[(k * 256 + threadIdx.x) & 4095];
    }
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j) fence_operands(acc[j]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int s = static_cast<int>(z);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) s += acc[j][i];
  if (s == 0x7EADBEEF) sink[0] = s;
}

}  // namespace

extern "C" {

int redsec_mma_sync_rate(int blocks, int iters, int* sink, cudaStream_t stream) {
  mma_sync_rate<<<blocks, 256, 0, stream>>>(iters, sink);
  return static_cast<int>(cudaGetLastError());
}

int redsec_wgmma_rate(int n, int blocks, int iters, int* sink, cudaStream_t stream) {
  switch (n) {
    case 32: wgmma_rate<32><<<blocks, 256, 0, stream>>>(iters, sink); break;
    case 64: wgmma_rate<64><<<blocks, 256, 0, stream>>>(iters, sink); break;
    case 128: wgmma_rate<128><<<blocks, 256, 0, stream>>>(iters, sink); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// kind 1 (multiply-add chain) or 2 (shared loads), mma 0 or 1
int redsec_wgmma_overlap(int kind, int mma, int work, int blocks, int iters, int* sink,
                         cudaStream_t stream) {
  if (kind == 1 && mma) wgmma_overlap<1, true><<<blocks, 256, 0, stream>>>(iters, work, sink);
  else if (kind == 1) wgmma_overlap<1, false><<<blocks, 256, 0, stream>>>(iters, work, sink);
  else if (mma) wgmma_overlap<2, true><<<blocks, 256, 0, stream>>>(iters, work, sink);
  else wgmma_overlap<2, false><<<blocks, 256, 0, stream>>>(iters, work, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// the library's Python module (py_entries.cuh)
REDSEC_PY_MODULE(mma_rate, REDSEC_PY_LAUNCH(redsec_mma_sync_rate),
                 REDSEC_PY_LAUNCH(redsec_wgmma_rate),
                 REDSEC_PY_LAUNCH(redsec_wgmma_overlap))
