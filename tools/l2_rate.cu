// Rate probes of the bootstrapping key's path from L2 into shared memory, as
// K4 (redsec_tpu_torch/csrc/pbs.cu, blind_rotate_kernel) reads it, on Hopper
// (sm_90a), a Python module of C entries (tools/l2_rate.py).  No TPU kernel
// is replaced and no path of the port runs these: they measure how fast the
// card can feed K4's MAC with key rows, which chose K4's layouts.
//
// - ring_async<N, RING>: the MAC's ring without its arithmetic.  A block of
//   512 threads walks rows of 8 x N int16 residues; each thread copies the
//   2 * E bytes of each of the 8 limb polynomials that it reads itself
//   (cp.async, 4 bytes at N = 1024, 8 at N = 2048), RING - 1 rows ahead, and
//   reads them back as 16-bit values.
// - ring_bulk<N, RING>: the same rows, each copied whole by one thread with
//   cp.async.bulk into a ring slot, a "full" mbarrier per slot that the copy
//   completes and an "empty" one that every warp arrives at once it has read
//   the slot.  The waits give up with a trap after about 2^27 tries.
// - ring_wide<N, RING>: ring_async with 16-byte copies, each warp copying
//   the words its threads read and meeting at __syncwarp() around them.
// - stream_rows: every block reads the same rows with 16-byte loads.
//
// Round r reads slice r % slices of the source, so that a source of a few
// MB stays in L2 (as one round's key slice does in K4, which every block
// reads at about the same time) and a larger one streams from memory.
// Each extern "C" entry returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "py_entries.cuh"

namespace {

constexpr int kT = 512;  // threads a block, as K4 at N = 1024 and 2048

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t smem_addr, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr), "l"(gmem),
               "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}

template <int N, int RING>
__global__ void __launch_bounds__(kT, 1) ring_async(const uint32_t* __restrict__ src, int slices,
                                                    int rows, int rounds, uint32_t* sink) {
  constexpr int E = N / kT;
  extern __shared__ uint4 smem_raw[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem_raw);  // [RING][8][N/2] words
  const int tid = threadIdx.x;
  const uint32_t mine = static_cast<uint32_t>(__cvta_generic_to_shared(ring + tid * (E / 2)));
  const uint16_t* ringh = reinterpret_cast<const uint16_t*>(ring + tid * (E / 2));
  const long long total = static_cast<long long>(rounds) * rows;
  const auto fetch = [&](long long q) {  // row q into slot q % RING, or an empty group
    if (q < total) {
      const long long r = q / rows, j = q - r * rows;
      const uint32_t* row = src + ((r % slices) * rows + j) * 8 * (N / 2) + tid * (E / 2);
      const int slot = static_cast<int>(q % RING);
#pragma unroll
      for (int o = 0; o < 8; ++o)
        cp_async<2 * E>(mine + 4u * ((slot * 8 + o) * (N / 2)), row + o * (N / 2));
    }
    cp_async_commit();
  };
  uint32_t acc = 0;
  for (int s = 0; s < RING - 1; ++s) fetch(s);
  for (long long q = 0; q < total; ++q) {
    fetch(q + RING - 1);
    cp_async_wait<RING - 1>();  // row q has landed
    const int slot = static_cast<int>(q % RING);
#pragma unroll
    for (int o = 0; o < 8; ++o)
#pragma unroll
      for (int e = 0; e < E; ++e) acc += ringh[(slot * 8 + o) * N + e];
  }
  if (acc == 0x7EADBEEFu) sink[0] = acc;
}

// ring_async's rows copied 16 bytes at a time: each warp copies the words
// its 32 threads read (E chunks a thread), waits for them and meets at
// __syncwarp() before reading, and again before refilling a slot.
template <int N, int RING>
__global__ void __launch_bounds__(kT, 1) ring_wide(const uint32_t* __restrict__ src, int slices,
                                                   int rows, int rounds, uint32_t* sink) {
  constexpr int E = N / kT, PIECES = 4 * E;  // 16-byte pieces of a limb a warp reads
  extern __shared__ uint4 smem_raw[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem_raw);  // [RING][8][N/2] words
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint16_t* ringh = reinterpret_cast<const uint16_t*>(ring + tid * (E / 2));
  const long long total = static_cast<long long>(rounds) * rows;
  const auto fetch = [&](long long q) {
    if (q < total) {
      const long long r = q / rows, j = q - r * rows;
      const uint32_t* row = src + ((r % slices) * rows + j) * 8 * (N / 2);
      const int slot = static_cast<int>(q % RING);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int c = lane + 32 * i, o = c / PIECES, piece = c % PIECES;
        const int word = o * (N / 2) + warp * 16 * E + piece * 4;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         base + 4u * (slot * 8 * (N / 2) + word)),
                     "l"(row + word)
                     : "memory");
      }
    }
    cp_async_commit();
  };
  uint32_t acc = 0;
  for (int s = 0; s < RING - 1; ++s) fetch(s);
  for (long long q = 0; q < total; ++q) {
    __syncwarp();  // the warp has read the slot row q + RING - 1 goes to
    fetch(q + RING - 1);
    cp_async_wait<RING - 1>();
    __syncwarp();  // row q has landed for the whole warp
    const int slot = static_cast<int>(q % RING);
#pragma unroll
    for (int o = 0; o < 8; ++o)
#pragma unroll
      for (int e = 0; e < E; ++e) acc += ringh[(slot * 8 + o) * N + e];
  }
  if (acc == 0x7EADBEEFu) sink[0] = acc;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long i = 0; i < (1ll << 27); ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  for (long long i = 0; i < (1ll << 27); ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

template <int N, int RING>
__global__ void __launch_bounds__(kT, 1) ring_bulk(const uint32_t* __restrict__ src, int slices,
                                                   int rows, int rounds, uint32_t* sink) {
  constexpr int E = N / kT, ROW_BYTES = 8 * N * 2;
  extern __shared__ uint4 smem_raw[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_raw);  // [RING][8 * N]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * 8 * N);
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(empty + s)),
                   "r"(kT / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long total = static_cast<long long>(rounds) * rows;
  const auto copy_row = [&](long long q) {  // thread 0: row q into slot q % RING
    const long long r = q / rows, j = q - r * rows;
    const int slot = static_cast<int>(q % RING);
    const uint32_t bar = smem_addr(full + slot);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(ROW_BYTES)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(ring + slot * 8 * N)),
        "l"(src + ((r % slices) * rows + j) * 8 * (N / 2)), "r"(ROW_BYTES), "r"(bar)
        : "memory");
  };
  if (tid == 0)
    for (int s = 0; s < RING && s < total; ++s) copy_row(s);
  uint32_t acc = 0;
  for (long long q = 0; q < total; ++q) {
    const int slot = static_cast<int>(q % RING);
    const uint32_t use = static_cast<uint32_t>((q / RING) & 1);
    mbar_wait(smem_addr(full + slot), use);
#pragma unroll
    for (int o = 0; o < 8; ++o)
#pragma unroll
      for (int e = 0; e < E; ++e) acc += ring[slot * 8 * N + o * N + tid * E + e];
    __syncwarp();
    if ((tid & 31) == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(empty + slot))
                   : "memory");
    if (tid == 0 && q + RING < total) {
      mbar_wait(smem_addr(empty + slot), use);  // every warp has read the slot
      copy_row(q + RING);
    }
  }
  if (acc == 0x7EADBEEFu) sink[0] = acc;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// ring_bulk's rows fetched once for a cluster of two blocks: thread 0 of
// block rank 0 copies each row into the same slot of both blocks
// (cp.async.bulk ... .multicast::cluster), which completes both blocks'
// "full" mbarriers; every warp of both blocks arrives at rank 0's "empty"
// mbarrier of the slot once it has read it; thread 0 of each block arms its
// own "full" mbarrier for each row.
template <int N, int RING>
__global__ void __launch_bounds__(kT, 1) ring_multicast(const uint32_t* __restrict__ src,
                                                        int slices, int rows, int rounds,
                                                        uint32_t* sink) {
  constexpr int E = N / kT, ROW_BYTES = 8 * N * 2;
  extern __shared__ uint4 smem_raw[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_raw);  // [RING][8 * N]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * 8 * N);
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x;
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(empty + s)),
                   "r"(2 * kT / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  const long long total = static_cast<long long>(rounds) * rows;
  const auto arm = [&](long long q) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_addr(full + q % RING)),
                 "r"(ROW_BYTES)
                 : "memory");
  };
  const auto copy_row = [&](long long q) {
    const long long r = q / rows, j = q - r * rows;
    const int slot = static_cast<int>(q % RING);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(ring + slot * 8 * N)),
        "l"(src + ((r % slices) * rows + j) * 8 * (N / 2)), "r"(ROW_BYTES),
        "r"(smem_addr(full + slot)), "h"(static_cast<uint16_t>(3))
        : "memory");
  };
  if (tid == 0)
    for (int s = 0; s < RING && s < total; ++s) {
      arm(s);
      if (rank == 0) copy_row(s);
    }
  uint32_t acc = 0;
  for (long long q = 0; q < total; ++q) {
    const int slot = static_cast<int>(q % RING);
    const uint32_t use = static_cast<uint32_t>((q / RING) & 1);
    mbar_wait(smem_addr(full + slot), use);
#pragma unroll
    for (int o = 0; o < 8; ++o)
#pragma unroll
      for (int e = 0; e < E; ++e) acc += ring[slot * 8 * N + o * N + tid * E + e];
    __syncwarp();
    if ((tid & 31) == 0) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(remote)
                   : "r"(smem_addr(empty + slot)), "r"(0u));
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
                   : "memory");
    }
    if (tid == 0 && q + RING < total) {
      arm(q + RING);
      if (rank == 0) {
        mbar_wait_cluster(smem_addr(empty + slot), use);  // both blocks have read the slot
        copy_row(q + RING);
      }
    }
  }
  cluster_sync();  // no block leaves while the other may still reach its shared memory
  if (acc == 0x7EADBEEFu) sink[0] = acc;
}

__global__ void __launch_bounds__(kT) stream_rows(const uint4* __restrict__ src, int slices,
                                             long long slice_vecs, int rounds, uint32_t* sink) {
  uint32_t acc = 0;
  for (int r = 0; r < rounds; ++r) {
    const uint4* s = src + (r % slices) * slice_vecs;
    for (long long i = threadIdx.x; i < slice_vecs; i += kT) {
      const uint4 v = s[i];
      acc += v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x7EADBEEFu) sink[0] = acc;
}

template <class Kernel>
int launch_ring(Kernel kernel, size_t bytes, int blocks, const uint32_t* src, int slices,
                int rows, int rounds, uint32_t* sink, cudaStream_t stream, int cluster = 1) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  if (cluster == 1) {
    kernel<<<blocks, kT, bytes, stream>>>(src, slices, rows, rounds, sink);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks / cluster * cluster);
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, src, slices, rows, rounds, sink);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// mode 0: ring_async, 1: ring_bulk, 2: ring_multicast (clusters of two
// blocks; an odd block count is cut to even), 3: ring_wide; N 1024 (a ring of 4 rows) or
// 2048 (2 rows), as K4's ring.  src: int16 [slices][rows][8][N].
int redsec_l2_ring(int mode, int N, int blocks, const uint32_t* src, int slices, int rows,
                   int rounds, uint32_t* sink, cudaStream_t stream) {
  if (blocks <= 1 || slices <= 0 || rows <= 0 || rounds <= 0 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 1024) {
    const size_t ring = 4ull * 8 * 1024 * 2;
    if (mode == 3)
      return launch_ring(ring_wide<1024, 4>, ring, blocks, src, slices, rows, rounds, sink,
                         stream);
    if (mode == 2)
      return launch_ring(ring_multicast<1024, 4>, ring + 64, blocks, src, slices, rows, rounds,
                         sink, stream, 2);
    return mode ? launch_ring(ring_bulk<1024, 4>, ring + 64, blocks, src, slices, rows, rounds,
                              sink, stream)
                : launch_ring(ring_async<1024, 4>, ring, blocks, src, slices, rows, rounds, sink,
                              stream);
  }
  if (N == 2048) {
    const size_t ring = 2ull * 8 * 2048 * 2;
    if (mode == 3)
      return launch_ring(ring_wide<2048, 2>, ring, blocks, src, slices, rows, rounds, sink,
                         stream);
    if (mode == 2)
      return launch_ring(ring_multicast<2048, 2>, ring + 64, blocks, src, slices, rows, rounds,
                         sink, stream, 2);
    return mode ? launch_ring(ring_bulk<2048, 2>, ring + 64, blocks, src, slices, rows, rounds,
                              sink, stream)
                : launch_ring(ring_async<2048, 2>, ring, blocks, src, slices, rows, rounds, sink,
                              stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int redsec_l2_stream(int blocks, const uint4* src, int slices, long long slice_vecs, int rounds,
                     uint32_t* sink, cudaStream_t s) {
  if (blocks <= 0 || slices <= 0 || slice_vecs <= 0 || rounds <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  stream_rows<<<blocks, kT, 0, s>>>(src, slices, slice_vecs, rounds, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// the library's Python module (py_entries.cuh)
REDSEC_PY_MODULE(l2_rate, REDSEC_PY_LAUNCH(redsec_l2_ring),
                 REDSEC_PY_LAUNCH(redsec_l2_stream))
