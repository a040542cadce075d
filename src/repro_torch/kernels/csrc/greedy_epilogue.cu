// Greedy epilogue over existing logits for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel greedy_epilogue_fwd (_epilogue_kernel) in
// src/repro/kernels/sampling/kernel.py: for logits (B, V) in float32 or
// bfloat16 (converted to f32 in registers, as the Pallas kernel's
// astype(float32)), each row's first maximal index and its log-probability
// max - logsumexp, without writing the normalized (B, V) log-probs.  Ties
// resolve to the first maximal index, as torch.argmax / jnp.argmax do.
//
// What bounds it on the card: bytes, and at serving sizes the latency of a
// launch and of one read.  The logits are read once: 1.6 MB at (8, 49152)
// f32, 0.5 us at 3.35 TB/s; 8.4 MB at gemma3-4b's (8, 262144), 2.5 us.  A
// design of two launches (partials, then a fold) pays two launch latencies
// and a dependency for half a microsecond of reading.
//
// Design: one launch of thread-block clusters, one cluster of C CTAs per row
// (C from greedy_cluster_plan in sampling/ops.py: 16 at B <= 8 and V >=
// 16384, fewer as B grows, so B x C is about one wave of 132 SMs).  Rank r
// of the cluster owns the contiguous slice [r * slice, (r + 1) * slice) of
// its row, in vocab order; slice is a multiple of 8 elements, so every
// slice starts 16 bytes after the last one.  A rank reads the 16-byte-
// aligned body of its slice with 16-byte register loads (ld.global.nc.v4),
// kLoads in flight a thread; the unaligned head and tail (fewer than 16
// bytes each, for a row start that is not 16-byte aligned) are scalar
// loads.  On an H100 80GB HBM3 these loads beat 1-D TMA bulk copies into a
// ring of mbarrier stages at every serving shape but B 1 at V 262144, and
// over a 256 MB stream (tools/greedy_variants.py carries that reader as a
// patch).  CTAs are 256 threads, or 512 where the clusters fill at most
// half the SMs and a slice is at least one round of a 256-thread CTA's
// loads (B <= 4 at the largest vocabularies): an SM then keeps twice the
// bytes in flight, 0.2-0.5 us off spans of 4.5-6.6 us on an H100 80GB HBM3
// (tools/greedy_variants.py), where at B 8 it costs 0.2-1.0 us.
// Each thread keeps a running (max, first argmax, sum exp(x - max)) over its
// elements in ascending vocab order; warps merge by shuffles, the CTA's
// warps through shared memory (larger value first, then the lower index).
// Each rank then stores its three values into rank 0's shared memory over
// distributed shared memory (map_shared_rank), and after a cluster barrier
// rank 0 merges them in rank order and writes tok and lp.  The store may
// only land in a CTA that runs: every thread arrives on the cluster barrier
// at its start and waits for the others just before the store, so that
// first barrier costs nothing behind the loads.  No partials reach device
// memory; there is no second launch.  A launch the card refuses (a cluster
// size it cannot schedule) returns its error: nothing falls back.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLoads = 8;               // 16-byte loads in flight a thread
constexpr int kMaxCluster = 16;         // non-portable: needs the attribute below
constexpr float kNegInf = -1e30f;       // an empty state's max: no inf - inf
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp(float x) {   // exp(0) is exactly 1
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// a running (max, first argmax, sum exp(x - max)); max doubles as the best
// value, so lp = max - (max + log(sum)) <= 0 exactly (sum >= 1)
struct Best {
  float m;
  int i;
  float l;
};

__device__ __forceinline__ Best empty_best() { return {kNegInf, INT32_MAX, 0.f}; }

// merge another state in: equal maxima keep the lower index, so the merge
// is symmetric and its order does not change the token
__device__ __forceinline__ void merge(Best& a, const Best& b) {
  const float mn = fmaxf(a.m, b.m);
  a.l = a.l * fast_exp(a.m - mn) + b.l * fast_exp(b.m - mn);
  if (b.m > a.m || (b.m == a.m && b.i < a.i)) a.i = b.i;
  a.m = mn;
}

// one element at vocab index v, above every index this thread has seen
__device__ __forceinline__ void push(Best& s, float x, int v) {
  if (x > s.m) {
    s.l = s.l * fast_exp(s.m - x) + 1.f;
    s.m = x;
    s.i = v;
  } else {
    s.l += fast_exp(x - s.m);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the 4 (f32) or 8 (bf16) logits of a 16-byte vector starting at index v0
template <typename T>
__device__ __forceinline__ void push_vec(Best& s, uint4 u, int v0) {
  constexpr int kVec = 16 / sizeof(T);
  float x[kVec];
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kVec == 4) {
      x[k] = __uint_as_float(w[k]);
    } else {                                   // bf16: the low half is the lower index
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  float vm = x[0];
  int vi = 0;
#pragma unroll
  for (int k = 1; k < kVec; ++k)
    if (x[k] > vm) {                           // ascending: > keeps the first
      vm = x[k];
      vi = k;
    }
  if (vm > s.m) {
    s.l *= fast_exp(s.m - vm);
    s.m = vm;
    s.i = v0 + vi;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) s.l += fast_exp(x[k] - s.m);
}

__device__ __forceinline__ Best shfl_merge(Best s, int width) {
  for (int off = width / 2; off > 0; off >>= 1) {
    const Best o = {__shfl_xor_sync(0xffffffffu, s.m, off), __shfl_xor_sync(0xffffffffu, s.i, off),
                    __shfl_xor_sync(0xffffffffu, s.l, off)};
    merge(s, o);
  }
  return s;
}

// the cluster barrier in two halves (every thread of every CTA takes part):
// an arrival, then a wait for every other thread's arrival
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {   // orders earlier writes
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {            // acquire
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads)
greedy_epilogue_kernel(const T* __restrict__ logits, long long row_stride, int V, int slice,
                       int32_t* __restrict__ tok, float* __restrict__ lp) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWarps = kThreads / 32;
  __shared__ float red_m[kWarps], red_l[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ Best ranks[kMaxCluster];                        // rank 0's: each rank's state

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  cluster_arrive_relaxed();          // this CTA runs: its shared memory may be written
  const T* row = logits + static_cast<long long>(blockIdx.y) * row_stride;

  // this rank's slice [lo, hi): head [lo, a0), 16-byte-aligned body [a0, a1), tail [a1, hi)
  const int lo = min(V, rank * slice), hi = min(V, lo + slice);
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row + lo) % 16) / sizeof(T));
  const int a0 = min(hi, lo + (mis ? kVec - mis : 0));
  const int a1 = a0 + (hi - a0) / kVec * kVec;

  Best s = empty_best();
  if (tid < a0 - lo) push(s, to_f32(row[lo + tid]), lo + tid);

  const int n_vec = (a1 - a0) / kVec;                        // 16-byte vectors of the body
  const uint4* body = reinterpret_cast<const uint4*>(row + a0);
  for (int j0 = 0; j0 < n_vec; j0 += kLoads * kThreads) {
    uint4 r[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * kThreads + tid;
      if (j < n_vec) r[u] = __ldg(body + j);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * kThreads + tid;
      if (j < n_vec) push_vec<T>(s, r[u], a0 + j * kVec);
    }
  }
  if (tid < hi - a1) push(s, to_f32(row[a1 + tid]), a1 + tid);

  // the warp, then the CTA's warps, then the cluster's ranks in rank order
  s = shfl_merge(s, 32);
  if (lane == 0) {
    red_m[warp] = s.m;
    red_i[warp] = s.i;
    red_l[warp] = s.l;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? Best{red_m[lane], red_i[lane], red_l[lane]} : empty_best();
    s = shfl_merge(s, 32);
  }
  cluster_wait();                    // every rank runs (long since, behind the loads)
  if (tid == 0) *cluster.map_shared_rank(&ranks[rank], 0) = s;     // push to rank 0
  cluster_arrive_release();
  cluster_wait();                    // every rank's state is in rank 0's shared memory
  if (rank == 0 && warp == 0) {
    s = lane < n_ranks ? ranks[lane] : empty_best();
    s = shfl_merge(s, 32);
    if (lane == 0) {
      tok[blockIdx.y] = s.i;
      lp[blockIdx.y] = s.m - (s.m + logf(fmaxf(s.l, 1e-30f)));
    }
  }
}

// grid (cluster, rows) of `threads`-thread CTAs in clusters of `cluster`
cudaLaunchConfig_t cluster_config(int cluster, int rows, int threads, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, rows);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int kThreads>
cudaError_t launch(const void* logits, long long row_stride, int N, int V, int cluster, int slice,
                   int32_t* tok, float* lp, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cluster, N, kThreads, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, greedy_epilogue_kernel<T, kThreads>,
                                             static_cast<const T*>(logits), row_stride, V, slice,
                                             tok, lp);
  if (err != cudaSuccess) cudaGetLastError();               // a refused launch is not sticky
  return err;
}

template <typename T, int kThreads>
cudaError_t allow_large_clusters() {
  return cudaFuncSetAttribute(greedy_epilogue_kernel<T, kThreads>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// Allows clusters above 8 CTAs for every instance of the kernel on the
// current card, then returns how many clusters of `cluster` 256-thread f32
// CTAs the card can hold at once (cudaOccupancyMaxActiveClusters); a
// negative CUDA error code if either fails.  0 means the cluster size
// cannot be scheduled.  Call it once per card before greedy_epilogue with a
// cluster above 8 (the wrapper caches it per card): the attribute never
// changes, so launches do not set it again.
extern "C" int greedy_active_clusters(int cluster) {
  cudaError_t err = allow_large_clusters<float, 256>();
  if (err == cudaSuccess) err = allow_large_clusters<float, 512>();
  if (err == cudaSuccess) err = allow_large_clusters<__nv_bfloat16, 256>();
  if (err == cudaSuccess) err = allow_large_clusters<__nv_bfloat16, 512>();
  int n = 0;
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, 256, 0, attr);
    err = cudaOccupancyMaxActiveClusters(&n, greedy_epilogue_kernel<float, 256>, &cfg);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return n;
}

// dtype codes: 0 = float32, 1 = bfloat16.  logits (N, V) with rows
// row_stride elements apart and the vocab contiguous; grid (cluster, N) in
// clusters of `cluster` CTAs of `threads` (256 or 512) threads, each rank
// reading `slice` logits (a multiple of 8).
extern "C" int greedy_epilogue(int dtype, const void* logits, long long row_stride, int N, int V,
                               int cluster, int slice, int threads, int32_t* tok, float* lp,
                               void* stream) {
  using Launch = cudaError_t (*)(const void*, long long, int, int, int, int, int32_t*, float*,
                                 cudaStream_t);
  Launch f = nullptr;
  if (dtype == 0 && threads == 256) f = launch<float, 256>;
  if (dtype == 0 && threads == 512) f = launch<float, 512>;
  if (dtype == 1 && threads == 256) f = launch<__nv_bfloat16, 256>;
  if (dtype == 1 && threads == 512) f = launch<__nv_bfloat16, 512>;
  if (f == nullptr || cluster < 1 || cluster > kMaxCluster || slice % 8 != 0 ||
      static_cast<long long>(cluster) * slice < V)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(f(logits, row_stride, N, V, cluster, slice, tok, lp,
                            static_cast<cudaStream_t>(stream)));
}
