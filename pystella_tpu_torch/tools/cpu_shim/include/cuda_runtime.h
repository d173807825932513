// CPU stand-in for the CUDA runtime: enough to run the port's fused
// kernels with g++ (see ../shim.py). A block's threads are fibers on one OS
// thread, so __syncthreads, __shfl_down_sync and shared memory keep their
// meaning; the blocks of a launch spread over up to 8 OS threads, so the
// per-thread state and the block's shared memory are thread_local.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <atomic>
#include <functional>
#include <stdlib.h>
#include <ucontext.h>
#include <cstddef>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __restrict__ __restrict

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct pk_uint3 { unsigned x, y, z; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline thread_local pk_uint3 threadIdx;
inline thread_local pk_uint3 blockIdx;
inline thread_local dim3 blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return 0; }
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }

// A block's threads are fibers on one OS thread; __syncthreads yields to
// the scheduler, which runs every fiber to its next barrier in turn.
struct pk_fiber { ucontext_t ctx; char* stack; pk_uint3 tid; bool done; };
constexpr size_t PK_STACK = 1 << 17;
struct pk_fiber_set : std::vector<pk_fiber> {
  ~pk_fiber_set() { for (auto& f : *this) free(f.stack); }
};
struct pk_smem_buf {
  unsigned char* p = (unsigned char*)aligned_alloc(64, 1 << 18);
  ~pk_smem_buf() { free(p); }
};
inline thread_local pk_fiber_set pk_fiber_store;
inline thread_local std::vector<pk_fiber>* pk_fibs = nullptr;
inline thread_local pk_smem_buf pk_smem_store;
inline thread_local int pk_cur = 0;
inline thread_local ucontext_t pk_sched;
inline thread_local const std::function<void()>* pk_fn = nullptr;
inline thread_local unsigned char* pk_dyn_smem = nullptr;

inline void __syncthreads() {
  swapcontext(&(*pk_fibs)[pk_cur].ctx, &pk_sched);
}
inline thread_local double pk_shfl_buf[2][1024];
inline thread_local int pk_shfl_par = 0;
template <class T>
inline T __shfl_down_sync(unsigned, T v, int o) {
  const int tid = threadIdx.x + threadIdx.y * blockDim.x
                  + threadIdx.z * blockDim.x * blockDim.y;
  double* buf = pk_shfl_buf[pk_shfl_par];
  buf[tid] = (double)v;
  __syncthreads();
  const int lane = tid % 32;
  T r = lane + o < 32 ? (T)buf[tid + o] : v;
  // the next call writes the other buffer; this one's reads all happen
  // before that call's barrier
  pk_shfl_par ^= 1;
  return r;
}

inline void pk_entry() {
  (*pk_fn)();
  (*pk_fibs)[pk_cur].done = true;
}

inline void pk_run_block(dim3 block, size_t smem) {
  const unsigned n = block.x * block.y * block.z;
  pk_fibs = &pk_fiber_store;
  auto& fibs = *pk_fibs;
  while (fibs.size() < n) {
    pk_fiber f{};
    f.stack = (char*)malloc(PK_STACK);
    fibs.push_back(f);
  }
  memset(pk_dyn_smem, 0xff, smem > 0 ? smem : 1);
  for (unsigned t = 0; t < n; ++t) {
    pk_fiber& f = fibs[t];
    f.done = false;
    f.tid = {t % block.x, (t / block.x) % block.y, t / (block.x * block.y)};
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack;
    f.ctx.uc_stack.ss_size = PK_STACK;
    f.ctx.uc_link = &pk_sched;
    makecontext(&f.ctx, pk_entry, 0);
  }
  pk_shfl_par = 0;
  bool live = true;
  while (live) {
    live = false;
    for (unsigned t = 0; t < n; ++t) {
      if (fibs[t].done) continue;
      pk_cur = t;
      threadIdx = fibs[t].tid;
      swapcontext(&pk_sched, &fibs[t].ctx);
      live = live || !fibs[t].done;
    }
  }
}

template <class F>
inline void pk_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F&& f) {
  const std::function<void()> fn = f;
  const long nb = (long)grid.x * grid.y * grid.z;
  std::atomic<long> next{0};
  auto work = [&]() {
    gridDim = grid;
    blockDim = block;
    pk_fn = &fn;
    pk_dyn_smem = pk_smem_store.p;
    for (long b; (b = next++) < nb;) {
      blockIdx = {(unsigned)(b % grid.x), (unsigned)((b / grid.x) % grid.y),
                  (unsigned)(b / ((long)grid.x * grid.y))};
      pk_run_block(block, smem);
    }
  };
  const int W = nb < 8 ? (int)nb : 8;
  std::vector<std::thread> ts;
  for (int w = 0; w < W; ++w) ts.emplace_back(work);
  for (auto& t : ts) t.join();
}
