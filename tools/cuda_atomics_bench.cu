// Throughput of the add primitives that the binned-sum kernel
// (fugue_tpu_torch/csrc/bin_groupby.cu) chooses between, on one Hopper card:
// float and int atomics in a block's shared memory, with and without a hot
// address; the same split over copies by lane or by warp, or combined with
// __match_any_sync; float and int atomics and plain stores into another
// block's shared memory (distributed shared memory, DSMEM); float atomics
// into a 1 MiB table in global memory (L2); and cluster.sync().
//
// Every launch is one block of 1024 threads a SM (128 KB of shared memory),
// as many clusters as fit; each thread does 256 operations. A line gives the
// time of one launch (mean of 5) and the operations a second, and a clock a
// SM at 1.755 GHz (the H100 SXM's boost clock). For cluster.sync() an
// operation is one sync of one thread: time / 256 is the time of one sync.
//
// Build and run on the card (python3 chip_turns.py --atomics does both):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o fugue_tpu_torch/build/cuda_atomics_bench tools/cuda_atomics_bench.cu
//   fugue_tpu_torch/build/cuda_atomics_bench

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kSlots = 32768;  // floats of shared memory a block: 128 KB
constexpr int kIters = 256;

enum Mode {
  kLocal,           // random address, float
  kLocalHot,        // 10% on one address, float
  kLocalHotInt,     // 10% on one address, int
  kLocalHotMatch,   // 10% on one address, combined by __match_any_sync
  kLocalMatch,      // random address, combined by __match_any_sync
  kLaneRep2, kLaneRep4, kLaneRep8, kLaneRep32,  // 10% hot, copies by lane
  kWarpRep4, kWarpRep8,                         // 10% hot, copies by warp
  kCounters,        // int atomic with result on one of 7 counters
  kRemoteFloat,     // float atomicAdd through map_shared_rank
  kRemoteRedFloat,  // red.shared::cluster.add.f32
  kRemoteRedInt,    // red.shared::cluster.add.u32
  kRemoteStore,     // st.shared::cluster.f32
  kGlobal,          // float atomicAdd into 2^18 floats of global memory
  kClusterSync,     // cluster.sync()
};

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352d;
  x ^= x >> 15;
  x *= 0x846ca68b;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t remote(float* local, uint32_t rank) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(local)), out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) bench(float* g) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float tab[];
  for (int j = threadIdx.x; j < kSlots; j += blockDim.x) tab[j] = 0.f;
  cluster.sync();
  const uint32_t csize = cluster.num_blocks(), rank = cluster.block_rank();
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t s = mix(blockIdx.x * kThreads + threadIdx.x + 1);
  for (int i = 0; i < kIters; ++i) {
    s = mix(s + i);
    const uint32_t slot = s & (kSlots - 1);
    const bool hot = (s % 100u) < 10u;
    const uint32_t other = csize > 1 ? (rank + 1 + (s >> 20) % (csize - 1)) % csize : 0;
    if constexpr (MODE == kLocal) atomicAdd(&tab[slot], 1.0f);
    if constexpr (MODE == kLocalHot) atomicAdd(&tab[hot ? 0 : slot], 1.0f);
    if constexpr (MODE == kLocalHotInt) atomicAdd(reinterpret_cast<int*>(&tab[hot ? 0 : slot]), 1);
    if constexpr (MODE == kLocalHotMatch || MODE == kLocalMatch) {
      const uint32_t a = (MODE == kLocalHotMatch && hot) ? 0 : slot;
      const unsigned peers = __match_any_sync(__activemask(), a);
      const int leader = __ffs(peers) - 1;
      float sum = 1.0f;
      for (unsigned rest = peers & (peers - 1); rest != 0; rest &= rest - 1)
        sum += __shfl_sync(peers, 1.0f, __ffs(rest) - 1);
      if (static_cast<int>(lane) == leader) atomicAdd(&tab[a], sum);
    }
    if constexpr (MODE >= kLaneRep2 && MODE <= kWarpRep8) {
      constexpr int R = MODE == kLaneRep2 ? 2 : MODE == kLaneRep4 || MODE == kWarpRep4 ? 4
                        : MODE == kLaneRep32 ? 32 : 8;
      constexpr bool by_lane = MODE <= kLaneRep32;
      const uint32_t copy = (by_lane ? lane : warp) & (R - 1);
      atomicAdd(&tab[copy * (kSlots / R) + (hot ? 0 : slot & (kSlots / R - 1))], 1.0f);
    }
    if constexpr (MODE == kCounters) {
      const int pos = atomicAdd(reinterpret_cast<int*>(&tab[32 + (s >> 8) % 7]), 1);
      tab[1024 + (pos & 4095)] = 1.0f;
    }
    if constexpr (MODE == kRemoteFloat) atomicAdd(cluster.map_shared_rank(&tab[slot], other), 1.0f);
    if constexpr (MODE == kRemoteRedFloat)
      asm volatile("red.shared::cluster.add.f32 [%0], %1;" ::"r"(remote(&tab[slot], other)),
                   "f"(1.0f) : "memory");
    if constexpr (MODE == kRemoteRedInt)
      asm volatile("red.shared::cluster.add.u32 [%0], %1;" ::"r"(remote(&tab[slot], other)),
                   "r"(1u) : "memory");
    if constexpr (MODE == kRemoteStore)
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote(&tab[slot], other)),
                   "f"(1.0f) : "memory");
    if constexpr (MODE == kGlobal) atomicAdd(&g[s & ((1 << 18) - 1)], 1.0f);
    if constexpr (MODE == kClusterSync) cluster.sync();
  }
  cluster.sync();
  if (threadIdx.x == 0) g[blockIdx.x] += tab[0];  // keeps the table's work observable
}

template <int MODE>
void run(const char* name, int csize, float* g) {
  auto kernel = bench<MODE>;
  const size_t smem = kSlots * sizeof(float);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess || clusters < 1) {
    printf("%-24s C=%2d no launch: %s\n", name, csize, cudaGetErrorString(err));
    return;
  }
  cfg.gridDim = dim3(clusters * csize);
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  cudaLaunchKernelEx(&cfg, kernel, g);  // warm-up
  cudaEventRecord(start);
  for (int rep = 0; rep < 5; ++rep) cudaLaunchKernelEx(&cfg, kernel, g);
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  err = cudaGetLastError();
  float ms = 0;
  cudaEventElapsedTime(&ms, start, stop);
  ms /= 5;
  const int blocks = clusters * csize;
  const double ops = static_cast<double>(blocks) * kThreads * kIters;
  const double rate = ops / (ms * 1e-3);
  printf("%-24s C=%2d blocks=%3d %.4f ms %.3e ops/s %.2f ops/clk/SM %s\n", name, csize, blocks, ms,
         rate, rate / blocks / 1.755e9, cudaGetErrorString(err));
}

int main() {
  float* g = nullptr;
  cudaMalloc(&g, (1 << 18) * sizeof(float));
  cudaMemset(g, 0, (1 << 18) * sizeof(float));
  run<kLocal>("local_f32", 1, g);
  run<kLocalHot>("local_f32_hot10", 1, g);
  run<kLocalHotInt>("local_i32_hot10", 1, g);
  run<kLocalHotMatch>("local_f32_hot10_match", 1, g);
  run<kLocalMatch>("local_f32_match", 1, g);
  run<kLaneRep2>("hot10_lane_copies2", 1, g);
  run<kLaneRep4>("hot10_lane_copies4", 1, g);
  run<kLaneRep8>("hot10_lane_copies8", 1, g);
  run<kLaneRep32>("hot10_lane_copies32", 1, g);
  run<kWarpRep4>("hot10_warp_copies4", 1, g);
  run<kWarpRep8>("hot10_warp_copies8", 1, g);
  run<kCounters>("counters7_with_result", 1, g);
  run<kGlobal>("global_f32_1MiB", 1, g);
  for (int csize : {2, 8, 16}) {
    run<kRemoteFloat>("remote_f32_atomicAdd", csize, g);
    run<kRemoteRedFloat>("remote_red_f32", csize, g);
    run<kRemoteRedInt>("remote_red_u32", csize, g);
    run<kRemoteStore>("remote_st_f32", csize, g);
    run<kClusterSync>("cluster_sync", csize, g);
  }
  cudaFree(g);
  return 0;
}
