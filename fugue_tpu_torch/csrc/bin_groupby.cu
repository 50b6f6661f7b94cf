// Per-bucket float32 SUM, and optionally the COUNT of valid rows, of values
// routed by an int32 bucket id: the dense groupby's binned reduction on
// Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of fugue_tpu/ops/pallas_groupby.py:
//   _sum_kernel (bin_sum_pallas)        -> fugue_bin_sum_count(counts = NULL)
//   _bin_kernel (bin_sum_count_pallas)  -> fugue_bin_sum_count(counts != NULL)
// One template on WITH_COUNT serves both.
//
// Contract (the Pallas kernels', with two changes stated below):
//   keys int32 (n,), clipped to [0, buckets); vals float32 (n,);
//   valid uint8 (n,) or NULL (= every row valid); sums float32 (buckets,)
//   and counts int32 (buckets,) are ZEROED BY THE CALLER: every block adds
//   into them with atomics, since blocks run in parallel and in no order
//   (the TPU's sequential grid carried one accumulator across its steps).
//
// Change 1, masking by selection. An invalid row is skipped, never
// multiplied by 0. The TPU kernel's one-hot product multiplies each value by
// 0 for every bucket the row does not belong to, so one inf or NaN in a
// row gives inf*0 = NaN in every bucket of its 1024-row chunk. Here an inf
// or NaN in a valid row lands only in its own bucket, and a NaN in an
// invalid row contributes nothing.
// Change 2, exact counts. Counts use int32 atomics, so they are exact up to
// 2^31-1 rows per bucket (the TPU kernel accumulated them in float32, exact
// only to 2^24).
//
// Bound: memory. A row is 4 bytes of key + 4 of value + 1 of valid flag,
// read once; the output is buckets*4 (or *8 with counts) bytes. At 100M
// rows that is ~0.9 GB, ~0.27 ms at the H100's 3.35 TB/s; the adds are
// ~1e8 operations, far below any compute bound.
//
// Design:
// - Small tables (the table fits the block's opt-in shared memory, up to
//   227 KB): a privatized histogram. Each block zeroes a table in shared
//   memory, walks its rows with a grid-stride loop, adds with shared-memory
//   atomics, then flushes its non-zero entries with one global atomic each.
// - Large tables (up to the dense path's 2^18 buckets): a shared-memory cache
//   of kCacheSlots bucket slots in front of global atomics. A bucket claims
//   the slot (bucket % kCacheSlots) the first time a row of it reaches an
//   empty slot; later rows of a claimed bucket add in shared memory, rows
//   whose slot another bucket holds add straight to global memory. Hot
//   buckets claim their slots early, so a skewed key distribution adds its
//   heavy buckets in shared memory: fewer same-address global atomics, and
//   per-block partial sums instead of one float32 running total over
//   millions of rows (which drifts by ~1e-4 relative at ~1e7 rows).
// Float32 atomics fix no order of summation: sums differ from run to run
// in the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCacheSlots = 8192;  // power of two
constexpr int32_t kEmpty = -1;

__device__ __forceinline__ int32_t clip_key(int32_t k, int32_t buckets) {
  return k < 0 ? 0 : (k >= buckets ? buckets - 1 : k);
}

template <bool WITH_COUNT>
__global__ void __launch_bounds__(kThreads)
    binned_shared(const int32_t* __restrict__ keys, const float* __restrict__ vals,
                  const uint8_t* __restrict__ valid, int64_t n, int32_t buckets,
                  float* __restrict__ sums, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_sum = reinterpret_cast<float*>(smem);
  int32_t* s_cnt = reinterpret_cast<int32_t*>(s_sum + buckets);
  for (int32_t b = threadIdx.x; b < buckets; b += blockDim.x) {
    s_sum[b] = 0.0f;
    if constexpr (WITH_COUNT) s_cnt[b] = 0;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (valid != nullptr && valid[i] == 0) continue;
    const int32_t b = clip_key(keys[i], buckets);
    atomicAdd(&s_sum[b], vals[i]);
    if constexpr (WITH_COUNT) atomicAdd(&s_cnt[b], 1);
  }
  __syncthreads();
  for (int32_t b = threadIdx.x; b < buckets; b += blockDim.x) {
    const float s = s_sum[b];
    if (s != 0.0f) atomicAdd(&sums[b], s);  // NaN != 0, so NaN and inf flush too
    if constexpr (WITH_COUNT) {
      const int32_t c = s_cnt[b];
      if (c != 0) atomicAdd(&counts[b], c);
    }
  }
}

template <bool WITH_COUNT>
__global__ void __launch_bounds__(kThreads)
    binned_cached(const int32_t* __restrict__ keys, const float* __restrict__ vals,
                  const uint8_t* __restrict__ valid, int64_t n, int32_t buckets,
                  float* __restrict__ sums, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_tag = reinterpret_cast<int32_t*>(smem);
  float* s_sum = reinterpret_cast<float*>(s_tag + kCacheSlots);
  int32_t* s_cnt = reinterpret_cast<int32_t*>(s_sum + kCacheSlots);
  for (int32_t j = threadIdx.x; j < kCacheSlots; j += blockDim.x) {
    s_tag[j] = kEmpty;
    s_sum[j] = 0.0f;
    if constexpr (WITH_COUNT) s_cnt[j] = 0;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (valid != nullptr && valid[i] == 0) continue;
    const int32_t b = clip_key(keys[i], buckets);
    const float v = vals[i];
    const int32_t slot = b & (kCacheSlots - 1);
    // a tag goes from kEmpty to a bucket once and never changes again, so a
    // stale read of kEmpty only costs the CAS that settles the claim
    int32_t tag = *reinterpret_cast<volatile int32_t*>(&s_tag[slot]);
    if (tag == kEmpty) {
      const int32_t old = atomicCAS(&s_tag[slot], kEmpty, b);
      tag = old == kEmpty ? b : old;
    }
    if (tag == b) {
      atomicAdd(&s_sum[slot], v);
      if constexpr (WITH_COUNT) atomicAdd(&s_cnt[slot], 1);
    } else {
      atomicAdd(&sums[b], v);
      if constexpr (WITH_COUNT) atomicAdd(&counts[b], 1);
    }
  }
  __syncthreads();
  for (int32_t j = threadIdx.x; j < kCacheSlots; j += blockDim.x) {
    const int32_t b = s_tag[j];
    if (b == kEmpty) continue;
    const float s = s_sum[j];
    if (s != 0.0f) atomicAdd(&sums[b], s);
    if constexpr (WITH_COUNT) {
      const int32_t c = s_cnt[j];
      if (c != 0) atomicAdd(&counts[b], c);
    }
  }
}

template <bool WITH_COUNT>
cudaError_t launch(const int32_t* keys, const float* vals, const uint8_t* valid, int64_t n,
                   int32_t buckets, float* sums, int32_t* counts, cudaStream_t stream) {
  if (n < 0 || buckets < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int dev = 0, sms = 0, smem_optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t bytes_per_bucket = WITH_COUNT ? 8 : 4;
  const size_t table = static_cast<size_t>(buckets) * bytes_per_bucket;
  const bool small = table <= static_cast<size_t>(smem_optin);
  auto kernel = small ? binned_shared<WITH_COUNT> : binned_cached<WITH_COUNT>;
  const size_t smem = small ? table : kCacheSlots * (4 + bytes_per_bucket);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  // enough blocks to fill every SM once; the grid-stride loop covers the rest
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < resident ? blocks : resident);
  kernel<<<grid, kThreads, smem, stream>>>(keys, vals, valid, n, buckets, sums, counts);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fugue_bin_sum_count(const int32_t* keys, const float* vals,
                                   const uint8_t* valid_or_null, int64_t n, int32_t buckets,
                                   float* sums, int32_t* counts_or_null, cudaStream_t s) {
  if (counts_or_null == nullptr) {
    return static_cast<int>(
        launch<false>(keys, vals, valid_or_null, n, buckets, sums, nullptr, s));
  }
  return static_cast<int>(
      launch<true>(keys, vals, valid_or_null, n, buckets, sums, counts_or_null, s));
}

extern "C" const char* fugue_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
