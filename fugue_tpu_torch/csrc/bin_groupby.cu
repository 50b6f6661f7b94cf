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
// Loads: both routes read their rows through one loop (for_each_row) of
// 16-byte loads, an int4 of keys, a float4 of values and 4 valid bytes a
// thread, two such vectors in flight per thread. The few rows before the
// keys reach 16-byte alignment and the ragged tail are read one by one; if
// keys, values and flags cannot be aligned at the same row (a sliced
// tensor's start), the whole range is read with scalar loads.
//
// Adds: a float atomicAdd in shared memory is a compare-and-swap loop on
// Hopper (ATOMS.CAST.SPIN in the SASS; integer adds are native), so rows of
// one bucket that meet in shared memory retry each other. Measured on an
// H100 80GB HBM3 at 700 W (tools/cuda_atomics_bench.cu): 1.91 float adds a
// clock a SM to random
// addresses, 0.21 when 10% of them hit one address; 0.38 float atomics a
// clock a SM into a 1 MiB table in L2; 0.17 float adds into another block's
// shared memory (distributed shared memory; a CAS loop across the SM-to-SM
// network).
//
// Routes. The caller picks one (ops/bin_groupby.py, _route) and passes the
// shared memory it sized; the launcher checks the layout and launches:
// - shared (the table fits one block's opt-in shared memory, up to 227 KB):
//   a privatized histogram. Each block zeroes a table in shared memory, adds
//   its rows with shared-memory atomics, then flushes its non-zero entries
//   with one global atomic each.
// - global (larger tables; the dense path's 2^18 buckets): each warp sums
//   its kHot hottest buckets in registers (HotKeys), and each block keeps a
//   cache of kCacheSlots claimed buckets in shared memory in front of global
//   atomics. A bucket claims the slot (bucket % kCacheSlots) the first time
//   a row of it reaches an empty slot; later rows of a claimed bucket add in
//   shared memory, rows whose slot another bucket holds add straight to
//   global memory. Hot buckets claim their slots early, so a skewed key
//   distribution adds its heavy buckets in registers and shared memory and
//   keeps per-block partial sums instead of one float32 running total over
//   millions of rows. A block of 1024 threads takes the whole 128 KB (sums)
//   or 192 KB (with counts) cache.
//   A table spread over a thread block cluster's shared memory was built
//   and measured slower on every variant (PERF.md, Findings): remote float adds
//   are CAS loops at half the rate of L2 atomics, and exchanging rows
//   through per-rank outboxes between cluster.sync() phases costs more
//   shared-memory operations a row than the L2 atomics it saves.
// Float32 atomics fix no order of summation: sums differ from run to run
// in the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;         // shared route
constexpr int kGlobalThreads = 1024;  // global route: one block a SM takes the cache
constexpr int kCacheSlots = 16384;    // global route, a power of two; CACHE_SLOTS
constexpr int kHot = 2;               // buckets a warp sums in registers
constexpr int32_t kEmpty = -1;
constexpr uint32_t kAllValid = 0x01010101u;

// route ids, as ops/bin_groupby.py passes them
constexpr int kRouteShared = 0;
constexpr int kRouteGlobal = 1;

__device__ __forceinline__ int32_t clip_key(int32_t k, int32_t buckets) {
  return k < 0 ? 0 : (k >= buckets ? buckets - 1 : k);
}

// The rows of one launch, read in units: 4 rows by 16-byte loads (an int4
// of keys, a float4 of values, 4 valid bytes) where keys, values and flags
// reach a 16-byte boundary at the same row, else 1 row by scalar loads. In
// vector mode the few rows before that boundary and the ragged tail (at most
// 6 in all) are "extra" rows, read one by one.
struct Rows {
  const int32_t* keys;
  const float* vals;
  const uint8_t* valid;
  int64_t n;
  int64_t head;   // extra rows before the first vector
  int64_t units;  // vectors, or rows in scalar mode
  bool vec;

  __device__ Rows(const int32_t* k, const float* v, const uint8_t* m, int64_t rows)
      : keys(k), vals(v), valid(m), n(rows) {
    const uintptr_t key_addr = reinterpret_cast<uintptr_t>(keys);
    const int64_t head_rows = static_cast<int64_t>(((16 - (key_addr & 15)) & 15) >> 2);
    head = head_rows < n ? head_rows : n;
    vec = (key_addr & 3) == 0 && (reinterpret_cast<uintptr_t>(vals + head) & 15) == 0 &&
          (valid == nullptr || (reinterpret_cast<uintptr_t>(valid + head) & 3) == 0);
    if (!vec) head = 0;
    units = vec ? (n - head) >> 2 : n;
  }
  __device__ int64_t extras() const { return vec ? n - (units << 2) : 0; }
  __device__ int64_t extra(int64_t i) const { return i < head ? i : (units << 2) + i; }
  // unit u into k, v and its valid bytes m (a zero byte: absent or invalid)
  __device__ __forceinline__ void load(int64_t u, int4& k, float4& v, uint32_t& m) const {
    if (vec) {
      k = __ldcs(reinterpret_cast<const int4*>(keys + head) + u);
      v = __ldcs(reinterpret_cast<const float4*>(vals + head) + u);
      m = valid == nullptr ? kAllValid
                           : __ldcs(reinterpret_cast<const uint32_t*>(valid + head) + u);
    } else {
      k = make_int4(keys[u], 0, 0, 0);
      v = make_float4(vals[u], 0.f, 0.f, 0.f);
      m = valid == nullptr || valid[u] != 0 ? 1u : 0u;
    }
  }
};

// add(bucket, value) for each valid row of a unit
template <typename Add>
__device__ __forceinline__ void add_unit(const int4& k, const float4& v, uint32_t m,
                                         int32_t buckets, Add& add) {
  if (m & 0x000000ffu) add(clip_key(k.x, buckets), v.x);
  if (m & 0x0000ff00u) add(clip_key(k.y, buckets), v.y);
  if (m & 0x00ff0000u) add(clip_key(k.z, buckets), v.z);
  if (m & 0xff000000u) add(clip_key(k.w, buckets), v.w);
}

// add(bucket, value) for an extra row i
template <typename Add>
__device__ __forceinline__ void add_row(const Rows& r, int64_t i, int32_t buckets, Add& add) {
  if (r.valid == nullptr || r.valid[i] != 0) add(clip_key(r.keys[i], buckets), r.vals[i]);
}

// Calls add(bucket, value) once for every valid row of [0, n) that falls to
// this thread of the grid, two units in flight per thread.
template <typename Add>
__device__ __forceinline__ void for_each_row(const int32_t* __restrict__ keys,
                                             const float* __restrict__ vals,
                                             const uint8_t* __restrict__ valid, int64_t n,
                                             int32_t buckets, Add& add) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const Rows r(keys, vals, valid, n);
  if (tid < r.extras()) add_row(r, r.extra(tid), buckets, add);
  for (int64_t u = tid; u < r.units; u += 2 * nthreads) {
    int4 ka, kb = make_int4(0, 0, 0, 0);
    float4 va, vb = make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t ma, mb = 0;
    // both units are requested before either is used
    r.load(u, ka, va, ma);
    if (u + nthreads < r.units) r.load(u + nthreads, kb, vb, mb);
    add_unit(ka, va, ma, buckets, add);
    add_unit(kb, vb, mb, buckets, add);
  }
}

// True if bucket b holds slot `slot` of the block's cache, claiming the slot
// if it is empty. A tag goes from kEmpty to a bucket once and never changes
// again, so a stale read of kEmpty only costs the CAS that settles the claim.
__device__ __forceinline__ bool holds_slot(int32_t* s_tag, int32_t slot, int32_t b) {
  int32_t tag = *reinterpret_cast<volatile int32_t*>(&s_tag[slot]);
  if (tag == kEmpty) {
    const int32_t old = atomicCAS(&s_tag[slot], kEmpty, b);
    tag = old == kEmpty ? b : old;
  }
  return tag == b;
}

// The kHot hottest buckets of a warp, summed in registers. At the start the
// warp samples one row a lane and picks the buckets seen most often; a row of
// one of them adds to the thread's own sum and count, with no atomic, so the
// rows of a hot bucket (several in each warp instruction under a skewed key
// distribution) do not retry each other's compare-and-swap loops in the
// cache. Warp-collective: pick() and flush() need every lane of the warp.
template <bool WITH_COUNT>
struct HotKeys {
  int32_t key[kHot];
  float sum[kHot];
  int32_t cnt[kHot];

  __device__ void pick(const int32_t* keys, int64_t n, int32_t buckets) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) *
                        (n / stride > 0 ? n / stride : 1);
    int32_t sample = clip_key(keys[row < n ? row : n - 1], buckets);  // n > 0
    const unsigned lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < kHot; ++h) {
      // the sampled bucket with the most lanes (ties: the highest lane)
      const unsigned peers = __match_any_sync(0xffffffffu, sample);
      const unsigned score = sample == kEmpty ? 0u : (__popc(peers) << 5) | lane;
      const unsigned best = __reduce_max_sync(0xffffffffu, score);
      key[h] = best == 0 ? kEmpty : __shfl_sync(0xffffffffu, sample, best & 31);
      if (sample == key[h]) sample = kEmpty;
      sum[h] = 0.0f;
      cnt[h] = 0;
    }
  }
  __device__ __forceinline__ bool add(int32_t b, float v) {
#pragma unroll
    for (int h = 0; h < kHot; ++h) {
      if (b == key[h]) {
        sum[h] += v;
        if constexpr (WITH_COUNT) ++cnt[h];
        return true;
      }
    }
    return false;
  }
  // the warp's sums and counts to global memory, one atomic each
  __device__ void flush(float* sums, int32_t* counts) {
#pragma unroll
    for (int h = 0; h < kHot; ++h) {
      float s = sum[h];
      int32_t c = cnt[h];
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        if constexpr (WITH_COUNT) c += __shfl_xor_sync(0xffffffffu, c, off);
      }
      if ((threadIdx.x & 31) == 0 && key[h] != kEmpty) {
        if (s != 0.0f) atomicAdd(&sums[key[h]], s);
        if constexpr (WITH_COUNT) {
          if (c != 0) atomicAdd(&counts[key[h]], c);
        }
      }
    }
  }
};

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
  auto add = [&](int32_t b, float v) {
    atomicAdd(&s_sum[b], v);
    if constexpr (WITH_COUNT) atomicAdd(&s_cnt[b], 1);
  };
  for_each_row(keys, vals, valid, n, buckets, add);
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
__global__ void __launch_bounds__(kGlobalThreads)
    binned_global(const int32_t* __restrict__ keys, const float* __restrict__ vals,
                  const uint8_t* __restrict__ valid, int64_t n, int32_t buckets,
                  float* __restrict__ sums, int32_t* __restrict__ counts) {
  // [cache tags | cache sums | cache counts]
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_tag = reinterpret_cast<int32_t*>(smem);
  float* s_sum = reinterpret_cast<float*>(s_tag + kCacheSlots);
  int32_t* s_cnt = reinterpret_cast<int32_t*>(s_sum + kCacheSlots);
  for (int32_t j = threadIdx.x; j < kCacheSlots; j += blockDim.x) {
    s_tag[j] = kEmpty;
    s_sum[j] = 0.0f;
    if constexpr (WITH_COUNT) s_cnt[j] = 0;
  }
  HotKeys<WITH_COUNT> hot;
  hot.pick(keys, n, buckets);
  __syncthreads();
  auto add = [&](int32_t b, float v) {
    if (hot.add(b, v)) return;
    const int32_t slot = b & (kCacheSlots - 1);
    if (holds_slot(s_tag, slot, b)) {
      atomicAdd(&s_sum[slot], v);
      if constexpr (WITH_COUNT) atomicAdd(&s_cnt[slot], 1);
    } else {
      atomicAdd(&sums[b], v);
      if constexpr (WITH_COUNT) atomicAdd(&counts[b], 1);
    }
  };
  for_each_row(keys, vals, valid, n, buckets, add);
  hot.flush(sums, counts);
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

// Whether smem bytes of shared memory are the layout that the route's
// kernel expects for this table (ops/bin_groupby.py _route sizes them).
bool layout_ok(int route, int32_t buckets, bool with_count, size_t smem) {
  const size_t per_bucket = with_count ? 8 : 4;
  switch (route) {
    case kRouteShared:
      return smem == static_cast<size_t>(buckets) * per_bucket;
    case kRouteGlobal:
      return smem == static_cast<size_t>(kCacheSlots) * (4 + per_bucket);
    default:
      return false;
  }
}

template <bool WITH_COUNT>
cudaError_t launch(const int32_t* keys, const float* vals, const uint8_t* valid, int64_t n,
                   int32_t buckets, float* sums, int32_t* counts, int route, int64_t smem_bytes,
                   cudaStream_t stream) {
  if (n < 0 || buckets < 1 || smem_bytes < 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (!layout_ok(route, buckets, WITH_COUNT, smem)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int dev = 0, sms = 0, smem_optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_optin)) return cudaErrorInvalidValue;
  auto kernel = route == kRouteShared ? binned_shared<WITH_COUNT> : binned_global<WITH_COUNT>;
  const int threads = route == kRouteShared ? kThreads : kGlobalThreads;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  // enough blocks to fill every SM once, no more than have rows to read
  // (4 a thread); the grid-stride loop covers the rest
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t rows_per_block = 4 * static_cast<int64_t>(threads);
  const int64_t wanted = (n + rows_per_block - 1) / rows_per_block;
  const unsigned grid = static_cast<unsigned>(wanted < resident ? wanted : resident);
  kernel<<<grid, threads, smem, stream>>>(keys, vals, valid, n, buckets, sums, counts);
  return cudaGetLastError();
}

}  // namespace

// route and smem_bytes come from ops/bin_groupby.py's _route; a layout the
// kernels do not take returns cudaErrorInvalidValue.
extern "C" int fugue_bin_sum_count(const int32_t* keys, const float* vals,
                                   const uint8_t* valid_or_null, int64_t n, int32_t buckets,
                                   float* sums, int32_t* counts_or_null, int route,
                                   int64_t smem_bytes, cudaStream_t s) {
  if (counts_or_null == nullptr) {
    return static_cast<int>(launch<false>(keys, vals, valid_or_null, n, buckets, sums, nullptr,
                                          route, smem_bytes, s));
  }
  return static_cast<int>(launch<true>(keys, vals, valid_or_null, n, buckets, sums,
                                       counts_or_null, route, smem_bytes, s));
}

// The current device's opt-in shared memory per block, in bytes.
extern "C" int fugue_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

extern "C" const char* fugue_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
