// Shared helpers for the siddhi_tpu_torch kernels: the plain C export macro,
// the error-string export every library carries, block-wide scans built
// from warp shuffles (one element per thread), the grid barrier of a
// cooperative launch (K4, K7, K10, K11b, K13d), the one-lane copy of a 1-, 2-,
// 4- or 8-byte column (K12a, K12b), and the sum/min/max ops with their
// identities (K5b scans, K8 range extrema).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SIDDHI_API extern "C" __attribute__((visibility("default")))

// Every library exports this so the Python wrapper can name a failed launch.
#define SIDDHI_ERROR_STRING_EXPORT                                         \
  SIDDHI_API const char* siddhi_cuda_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));            \
  }

static inline int siddhi_launch_status() {
  return static_cast<int>(cudaGetLastError());
}

static inline unsigned siddhi_blocks(long long n, int block) {
  return static_cast<unsigned>((n + block - 1) / block);
}

// Exclusive prefix sum of one int per thread over the whole block.
// `smem` holds BLOCK/32 ints; `*total` receives the block's sum.
template <int BLOCK>
__device__ __forceinline__ int block_exclusive_sum(int v, int* smem,
                                                   int* total) {
  constexpr int NW = BLOCK / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NW ? smem[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NW) smem[lane] = w;
  }
  __syncthreads();
  const int warp_prefix = warp > 0 ? smem[warp - 1] : 0;
  *total = smem[NW - 1];
  __syncthreads();  // smem may be reused by the caller's next call
  return warp_prefix + x - v;
}

// Cooperative launches (K4, K7, K10, K11b, K13d): no more blocks than the
// card holds at once, so blocks may wait for each other. The barrier's
// counter and the done counter live in the library's workspace, zero on
// entry; the block that finishes last zeroes them again.

// All blocks of the grid arrive before any leaves; `phase` counts this
// block's barriers, so the counter only grows in a launch.
__device__ __forceinline__ void siddhi_grid_sync(unsigned* bar,
                                                 unsigned& phase) {
  __syncthreads();
  ++phase;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = phase * gridDim.x;
    while (*(volatile unsigned*)bar < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Called by every thread at the end of the launch: true (block-wide) in
// the block that finishes last, when every other block is done with the
// workspace; that block zeroes the barrier and the done counter.
__device__ __forceinline__ bool siddhi_grid_last(unsigned* bar,
                                                 unsigned* done) {
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
    if (last) {
      *bar = 0u;
      *done = 0u;
    }
  }
  return __syncthreads_or(last);
}

// Blocks of `kernel` (`block` threads, `smem` bytes of dynamic shared
// memory) that the card holds at once; 0 where it has no cooperative
// launches.
template <typename Kernel>
static inline int siddhi_coop_capacity(Kernel kernel, int block,
                                       size_t smem = 0) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block,
                                                    smem) != cudaSuccess)
    return 0;
  return coop ? sms * per_sm : 0;
}

// Copy one lane of a column `width` bytes wide (1, 2, 4 or 8).
__device__ __forceinline__ void siddhi_copy_lane(uint8_t* dst,
                                                 const uint8_t* src,
                                                 int width) {
  switch (width) {
    case 8:
      *reinterpret_cast<unsigned long long*>(dst) =
          *reinterpret_cast<const unsigned long long*>(src);
      break;
    case 4:
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(src);
      break;
    case 2:
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
      break;
    default:
      *dst = *src;
  }
}

// Identities of min and max per element type.
template <typename T>
struct Lim;
template <>
struct Lim<float> {
  static __device__ float hi() { return INFINITY; }
  static __device__ float lo() { return -INFINITY; }
};
template <>
struct Lim<double> {
  static __device__ double hi() { return static_cast<double>(INFINITY); }
  static __device__ double lo() { return -static_cast<double>(INFINITY); }
};
template <>
struct Lim<int> {
  static __device__ int hi() { return 0x7fffffff; }
  static __device__ int lo() { return -0x7fffffff - 1; }
};
template <>
struct Lim<long long> {
  static __device__ long long hi() { return 0x7fffffffffffffffLL; }
  static __device__ long long lo() { return -0x7fffffffffffffffLL - 1; }
};

// The ops of siddhi_tpu/ops/groupby.py `_OPS`; min and max propagate NaN
// as jnp.minimum / jnp.maximum do.
struct OpSum {
  template <typename T>
  static __device__ __forceinline__ T identity() { return T(0); }
  template <typename T>
  static __device__ __forceinline__ T apply(T a, T b) { return a + b; }
};
struct OpMin {
  template <typename T>
  static __device__ __forceinline__ T identity() { return Lim<T>::hi(); }
  template <typename T>
  static __device__ __forceinline__ T apply(T a, T b) {
    if (a != a) return a;
    if (b != b) return b;
    return b < a ? b : a;
  }
};
struct OpMax {
  template <typename T>
  static __device__ __forceinline__ T identity() { return Lim<T>::lo(); }
  template <typename T>
  static __device__ __forceinline__ T apply(T a, T b) {
    if (a != a) return a;
    if (b != b) return b;
    return b > a ? b : a;
  }
};
