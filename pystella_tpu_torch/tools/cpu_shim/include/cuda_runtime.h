// CPU stand-in for the CUDA runtime: enough to run the port's kernels with
// g++ (see ../shim.py). A block's threads are fibers on one OS thread, so
// __syncthreads, the warp's shuffles, votes and __syncwarp and shared memory
// keep their meaning: a fiber waits at __syncthreads until every thread of
// its block has reached it, and at a warp step until every thread of its
// warp has (the warps of a block may take different steps between two
// __syncthreads, as on the card). The blocks of a launch spread over up to 8
// OS threads, so the per-thread state and the block's shared memory are
// thread_local. A fiber runs until it reaches a barrier, so an atomicAdd on
// shared memory is a plain add here (no other fiber of the block runs in
// between); the kernels use no atomics on device memory.
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
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
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

// A block's threads are fibers on one OS thread; a barrier yields to the
// scheduler, which resumes every fiber in turn, each to its next yield; a
// fiber yields again until the threads it waits for have reached the
// barrier (`bars` counts a fiber's __syncthreads, `calls` its warp steps).
struct pk_fiber {
  ucontext_t ctx; char* stack; pk_uint3 tid; bool done;
  unsigned bars, calls;
};
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

inline thread_local unsigned pk_nfib = 0;

inline void pk_yield() { swapcontext(&(*pk_fibs)[pk_cur].ctx, &pk_sched); }

// yield until fibers [lo, hi) have each ended or counted past `n` in
// `field`
inline void pk_wait(unsigned pk_fiber::*field, unsigned n, unsigned lo,
                    unsigned hi) {
  for (;;) {
    pk_yield();
    const auto& fibs = *pk_fibs;
    unsigned t = lo;
    while (t < hi && (fibs[t].done || fibs[t].*field > n)) ++t;
    if (t == hi) return;
  }
}

inline void __syncthreads() {
  const unsigned n = (*pk_fibs)[pk_cur].bars++;
  pk_wait(&pk_fiber::bars, n, 0, pk_nfib);
}

// a barrier that also returns whether `p` holds on every thread of the
// block: a fiber's n-th barrier writes array n % 2, which no fiber writes
// again before every fiber has passed barrier n + 1, after its reading
inline thread_local int pk_block_buf[2][1024];
inline int __syncthreads_and(int p) {
  int* buf = pk_block_buf[(*pk_fibs)[pk_cur].bars & 1];
  const int tid = threadIdx.x + threadIdx.y * blockDim.x
                  + threadIdx.z * blockDim.x * blockDim.y;
  buf[tid] = p != 0;
  __syncthreads();
  for (unsigned t = 0; t < pk_nfib; ++t)
    if (!buf[t]) return 0;
  return 1;
}
// The warp's shuffles, votes and __syncwarp: every fiber writes its value
// into a per-block array and waits until its warp's 32 have written, then
// reads theirs. A fiber's n-th step uses array n % 2: a fiber that runs on
// to its next step writes the other array, and cannot pass that step
// before the slowest of its warp has read this one.
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline thread_local unsigned long long pk_warp_buf[2][1024];

inline int pk_flat_tid() {
  return threadIdx.x + threadIdx.y * blockDim.x
         + threadIdx.z * blockDim.x * blockDim.y;
}

// write `v`, yield, and return the warp's 32 values' array (this fiber's
// lane 0 at the front)
template <class T>
inline const unsigned long long* pk_warp_exchange(T v) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "a warp word");
  const int tid = pk_flat_tid();
  const unsigned n = (*pk_fibs)[pk_cur].calls++;
  unsigned long long* buf = pk_warp_buf[n & 1];
  unsigned long long w = 0;
  memcpy(&w, &v, sizeof(T));
  buf[tid] = w;
  const unsigned lo = pk_cur - pk_cur % 32;
  pk_wait(&pk_fiber::calls, n, lo, lo + 32 < pk_nfib ? lo + 32 : pk_nfib);
  return buf + (tid - tid % 32);
}

inline void __syncwarp(unsigned = 0xffffffffu) { pk_warp_exchange(0); }

template <class T>
inline T pk_warp_word(const unsigned long long* warp, int lane) {
  T r;
  memcpy(&r, warp + lane, sizeof(T));
  return r;
}

template <class T>
inline T __shfl_down_sync(unsigned, T v, int o) {
  const int lane = pk_flat_tid() % 32;
  const unsigned long long* warp = pk_warp_exchange(v);
  return lane + o < 32 ? pk_warp_word<T>(warp, lane + o) : v;
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, int o) {
  const int lane = pk_flat_tid() % 32;
  const unsigned long long* warp = pk_warp_exchange(v);
  return lane - o >= 0 ? pk_warp_word<T>(warp, lane - o) : v;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  const unsigned long long* warp = pk_warp_exchange(v);
  return pk_warp_word<T>(warp, src & 31);
}
inline unsigned __ballot_sync(unsigned, int p) {
  const unsigned long long* warp = pk_warp_exchange((int)(p != 0));
  unsigned m = 0;
  for (int l = 0; l < 32; ++l)
    if (pk_warp_word<int>(warp, l)) m |= 1u << l;
  return m;
}
inline int __all_sync(unsigned mask, int p) {
  return __ballot_sync(mask, p) == 0xffffffffu;
}
inline int __any_sync(unsigned mask, int p) {
  return __ballot_sync(mask, p) != 0u;
}
template <class T>
inline unsigned __match_any_sync(unsigned, T v) {
  const unsigned long long* warp = pk_warp_exchange((long long)v);
  unsigned m = 0;
  for (int l = 0; l < 32; ++l)
    if (pk_warp_word<long long>(warp, l) == (long long)v) m |= 1u << l;
  return m;
}

// a shared-memory atomic: a plain add (see the top of this file)
template <class T>
inline T atomicAdd(T* a, T v) {
  const T old = *a;
  *a = old + v;
  return old;
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
  pk_nfib = n;
  for (unsigned t = 0; t < n; ++t) {
    pk_fiber& f = fibs[t];
    f.done = false;
    f.bars = f.calls = 0;
    f.tid = {t % block.x, (t / block.x) % block.y, t / (block.x * block.y)};
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack;
    f.ctx.uc_stack.ss_size = PK_STACK;
    f.ctx.uc_link = &pk_sched;
    makecontext(&f.ctx, pk_entry, 0);
  }
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
