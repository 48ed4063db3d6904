// A host shim that lets g++ compile and run the CUDA kernels of this
// directory on the CPU, for tests on machines without nvcc or a card.
//
// Use: put a file named cuda_runtime.h that includes this one on the
// include path, rewrite every launch `kern<<<blocks, threads, smem,
// stream>>>(args);` into `shim_launch(kern, blocks, threads, smem,
// args);` and every `extern __shared__ ... name[];` into
// `unsigned char *name = shim_shared();` (tests/test_torch_ale_host.py
// does both with regular expressions; a file-scope declaration then
// points at the shim's one fixed buffer), then build with
// `g++ -std=c++17 -O1 -ffp-contract=off -shared -fPIC -pthread`.
//
// A launch runs its blocks one after another (a grid of up to three
// dimensions).  By default a block runs
// with one thread (blockDim.x = 1), which gives a kernel's result
// whenever each of its stages is a loop over the block's points with
// stride blockDim.x, the stages separated by __syncthreads() (a no-op
// here).  After shim_set_block_threads(-1) a block runs the launch's own
// thread count as that many host threads that meet at a real barrier in
// __syncthreads() (build with -pthread): this checks the kernel's
// mapping of points to threads, which one thread per block cannot, and
// runs a kernel without barriers that needs its own thread count.  Dynamic shared memory is filled with 0xFF bytes
// (NaN in float and double) before each block, so that a read of a
// point no stage wrote shows in the result.  A launch that asks for more
// than the H100's 232,448 B of it runs no block and makes
// cudaGetLastError return an error, as the device's launch would.
//
// `__ldg` is a plain read and `min` the integer minimum.  Device pointers
// are host pointers here.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

typedef int cudaError_t;
typedef void *cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

static thread_local dim3 threadIdx;
static dim3 blockIdx, blockDim, gridDim;
static int shim_block_threads = 1;
// opt-in shared memory per block of an H100
static const int kShimSharedOptin = 232448;
// the dynamic shared memory, one fixed buffer, so that a pointer to it
// taken when the library loads (a file-scope `extern __shared__`) holds
static std::vector<unsigned char> shim_smem(kShimSharedOptin);

// 1: one thread per block; -1: the launch's threads, as host threads
extern "C" void shim_set_block_threads(int n) { shim_block_threads = n; }

// the block's barrier when its threads are host threads
struct ShimBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 1, count = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != g; });
    }
  }
};
static ShimBarrier shim_barrier;

inline void __syncthreads() {
  if (shim_block_threads < 0) shim_barrier.wait();
}

inline unsigned char *shim_shared() { return shim_smem.data(); }

inline int atomicMax(int *a, int v) {
  int old = __atomic_load_n(a, __ATOMIC_RELAXED);
  while (old < v && !__atomic_compare_exchange_n(a, &old, v, true,
                                                 __ATOMIC_RELAXED,
                                                 __ATOMIC_RELAXED)) {
  }
  return old;
}

inline int atomicMin(int *a, int v) {
  int old = __atomic_load_n(a, __ATOMIC_RELAXED);
  while (old > v && !__atomic_compare_exchange_n(a, &old, v, true,
                                                 __ATOMIC_RELAXED,
                                                 __ATOMIC_RELAXED)) {
  }
  return old;
}

// the read-only data cache's load, and the integer minimum of device code
template <typename T>
inline T __ldg(const T *p) { return *p; }

inline int min(int a, int b) { return b < a ? b : a; }

// a launch the device would refuse records its error here, and
// cudaGetLastError returns it and clears it, as the runtime does
inline cudaError_t shim_last_error = cudaSuccess;

inline cudaError_t cudaGetLastError() {
  const cudaError_t err = shim_last_error;
  shim_last_error = cudaSuccess;
  return err;
}

inline cudaError_t cudaGetDevice(int *dev) {
  *dev = 0;
  return cudaSuccess;
}

inline cudaError_t cudaDeviceGetAttribute(int *value, int attr, int) {
  *value = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin
               ? kShimSharedOptin : 0;
  return cudaSuccess;
}

template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int attr, int value) {
  return attr == cudaFuncAttributeMaxDynamicSharedMemorySize
                 && value > kShimSharedOptin
             ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename F, typename... A>
void shim_launch(F kern, dim3 grid, int threads, size_t smem,
                 const A &...args) {
  const int nth = shim_block_threads < 0 ? threads : 1;
  gridDim = grid;
  blockDim.x = nth;
  shim_barrier.n = nth;
  if (smem > shim_smem.size()) {
    shim_last_error = cudaErrorInvalidValue;
    return;
  }
  for (unsigned b = 0; b < grid.x * grid.y * grid.z; ++b) {
    blockIdx.x = b % grid.x;
    blockIdx.y = b / grid.x % grid.y;
    blockIdx.z = b / grid.x / grid.y;
    memset(shim_smem.data(), 0xFF, smem);
    if (shim_block_threads < 0) {
      std::vector<std::thread> pool;
      for (int t = 0; t < nth; ++t)
        pool.emplace_back([&, t] {
          threadIdx.x = t;
          kern(args...);
        });
      for (auto &th : pool) th.join();
      continue;
    }
    for (int t = 0; t < nth; ++t) {
      threadIdx.x = t;
      kern(args...);
    }
  }
}
