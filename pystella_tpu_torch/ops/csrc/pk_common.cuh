// Shared pieces of the fused Runge-Kutta stencil kernels (fused_stage.cu,
// fused_pair.cu, fused_coupled_pair.cu, fused_chunk.cu): the math functions
// that ops/codegen.py prints, periodic index wrap, the carry storage type,
// the tap loaders, the Laplacian and the gradient in the accumulation order
// of the JAX package's lap_from_taps and grad_from_taps
// (pystella_tpu/ops/pallas_stencil.py), the lattice arrays a launch passes,
// and the deterministic lattice sums of the energy-emitting kernels.
//
// Every kernel is compiled against a generated header, pk_model.cuh, which
// defines PK_F (number of fields), PK_H (stencil radius),
// pk_dvdf<T>(f, a, hubble, out) and pk_v<T>(f, a, hubble), the model's
// dV/df_i and V at one site, and, for a model whose V does not read the
// Hubble rate, PK_HUBBLE_FREE with pk_dvdf_nohub<T>(f, a, out) and
// pk_v_nohub<T>(f, a). For the gravitational-wave system it also defines
// PK_NH (number of hij components), PK_GW_COEF (16 pi) and
// pk_sij<T>(dfdx, a, hubble, out), the anisotropic stress S_ij from the
// site's field gradients (with PK_HUBBLE_FREE also pk_sij_nohub); the
// kernels' GW variants are compiled only then.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PK_MATH1(name, fnf, fnd)                                            \
  __device__ __forceinline__ float pk_##name(float x) { return fnf(x); }    \
  __device__ __forceinline__ double pk_##name(double x) { return fnd(x); }

PK_MATH1(exp, expf, exp)
PK_MATH1(log, logf, log)
PK_MATH1(sin, sinf, sin)
PK_MATH1(cos, cosf, cos)
PK_MATH1(tan, tanf, tan)
PK_MATH1(sinh, sinhf, sinh)
PK_MATH1(cosh, coshf, cosh)
PK_MATH1(tanh, tanhf, tanh)
PK_MATH1(sqrt, sqrtf, sqrt)
PK_MATH1(fabs, fabsf, fabs)
PK_MATH1(arcsin, asinf, asin)
PK_MATH1(arccos, acosf, acos)
PK_MATH1(arctan, atanf, atan)
#undef PK_MATH1

__device__ __forceinline__ float pk_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pk_pow(double x, double y) { return pow(x, y); }

template <typename T>
__device__ __forceinline__ T pk_sign(T x) {
  return T((x > T(0)) - (x < T(0)));
}

// The generated model comes after the math functions: pk_dvdf is a template
// whose calls on float/double arguments bind at its definition.
#include "pk_model.cuh"

// Periodic wrap of a lattice index that is at most one stencil radius out
// of range in the common case; any offset is still wrapped correctly.
__device__ __forceinline__ int pk_wrap(int i, int n) {
  if (i >= n || i < 0) {
    i %= n;
    if (i < 0) i += n;
  }
  return i;
}

// The sharded tier (the halo-input kernel, StreamingStencil.
// _build_xhalo of pystella_tpu/ops/pallas_stencil.py): a window input may be
// padded along x (PK_PAD_X) and/or y (PK_PAD_Y) with its neighbours' rows.
// Along a padded axis a tap is read at its offset from the window's origin
// and never wrapped; along the others it wraps periodically as before. PAD
// is a compile-time bit set (0: the unsharded kernels, unchanged).
#define PK_PAD_X 1
#define PK_PAD_Y 2
// A loader in box coordinates (the x-march's shared planes, below): no axis
// wraps. Only pk_lap, pk_grad and fd_ops.cu's pk_pd take this bit.
#define PK_PAD_Z 4
#define PK_BOX (PK_PAD_X | PK_PAD_Y | PK_PAD_Z)

// A neighbour index i along an axis of extent n: wrapped, unless the axis is
// padded. Unpadded, the call is pk_wrap's on the same expression, so the
// unsharded kernels compile as they did before the sharded tier.
template <bool PADDED>
__device__ __forceinline__ int pk_tap(int i, int n) {
  if constexpr (PADDED)
    return i;
  else
    return pk_wrap(i, n);
}

// Geometry of a launch in the sharded tier, passed by value beside X, Y, Z
// (PkArrays does not grow). The kernel computes an (X, Y, Z) region. Window
// inputs are read through their storage, whose component stride is Nw and
// y extent Ys, from pointers the host set to the region's origin (padded
// rows lie at negative offsets). Blockwise inputs and outputs are the full
// block (component stride Nb), their pointers set to the region's first x
// row, so an interior or shell launch writes into the full output block in
// place. An unpadded launch has Nb = Nw = X * Y * Z and Ys = Y.
//
// The sum kernels (K5, K6, K9, K5') place each tile's partial sums at the
// index the per-site block of that tile has in the launch over the whole
// lattice (pk_march_sums): x0 is the region's first x row in the lattice,
// yb0 its first y block and GYb the lattice's number of y blocks. One
// pk_reduce_partials_kernel over the lattice's partials then gives the
// unsharded launch's sums bit for bit, when every shard's y blocks are the
// lattice's (its Y a multiple of PK_BLOCK_Y, or y unsharded). x0 = yb0 = 0
// with GYb the region's own count index the region's partials alone.
struct PkGeom {
  int64_t Nb, Nw;
  int Ys;
  int x0, yb0, GYb;
};

// Laplacian weights: w0 = coefs[0] * sum(1/dx^2), and per offset s = 1..H
// and axis, coefs[s] / dx_axis^2 (host-computed in double, then cast to T,
// exactly as the JAX body's Python-float coefficients meet an f32 array).
template <typename T>
struct PkLapWeights {
  T w0;
  T wx[PK_H], wy[PK_H], wz[PK_H];
};

// Value of one component of a lattice array at (x, y, z).
template <typename T>
struct PkLoad {
  const T* __restrict__ p;
  int Y, Z;
  __device__ __forceinline__ T operator()(int x, int y, int z) const {
    return p[((int64_t)x * Y + y) * Z + z];
  }
};

// RK carries (the k arrays) stored in C, computed in T. With C = T both
// conversions are the identity, so a kernel instantiated that way is the
// working-precision kernel unchanged. With C = __nv_bfloat16 (the
// steppers' carry_dtype=torch.bfloat16) a load widens exactly and a store
// rounds to nearest even -- what the JAX package's astype and torch's .to
// do. From double, the store rounds through float first, as c10::BFloat16
// does, so kernel and plain PyTorch version round alike.
template <typename T, typename C>
struct PkCarry {
  __device__ __forceinline__ static T load(C v) { return v; }
  __device__ __forceinline__ static C store(T v) { return v; }
};

template <>
struct PkCarry<float, __nv_bfloat16> {
  __device__ __forceinline__ static float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct PkCarry<double, __nv_bfloat16> {
  __device__ __forceinline__ static double load(__nv_bfloat16 v) {
    return (double)__bfloat162float(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 store(double v) {
    return __float2bfloat16_rn((float)v);
  }
};

// v rounded to the carry type and widened back: the value a carry has
// after a round trip through device memory.
template <typename T, typename C>
__device__ __forceinline__ T pk_carry_round(T v) {
  return PkCarry<T, C>::load(PkCarry<T, C>::store(v));
}

// lap = w0 * centre, then for s = 1..H: the x pair, the y pair, the z pair,
// each as acc + w * (tap(+s) + tap(-s)) -- lap_from_taps term by term.
// PAD: the window's padded axes (PK_PAD_X, PK_PAD_Y), read unwrapped;
// PK_BOX: a loader in box coordinates, nothing wrapped.
template <int PAD = 0, typename T, typename Load>
__device__ __forceinline__ T pk_lap(const Load& load, T centre, int x, int y,
                                    int z, int X, int Y, int Z,
                                    const PkLapWeights<T>& w) {
  constexpr bool PX = PAD & PK_PAD_X, PY = PAD & PK_PAD_Y;
  constexpr bool PZ = PAD & PK_PAD_Z;
  T acc = w.w0 * centre;
#pragma unroll
  for (int s = 1; s <= PK_H; ++s) {
    acc = acc + w.wx[s - 1] * (load(pk_tap<PX>(x + s, X), y, z)
                               + load(pk_tap<PX>(x - s, X), y, z));
    acc = acc + w.wy[s - 1] * (load(x, pk_tap<PY>(y + s, Y), z)
                               + load(x, pk_tap<PY>(y - s, Y), z));
    acc = acc + w.wz[s - 1] * (load(x, y, pk_tap<PZ>(z + s, Z))
                               + load(x, y, pk_tap<PZ>(z - s, Z)));
  }
  return acc;
}

// Gradient weights: per axis and offset s = 1..H, coefs[s] * (1 / dx_axis)
// (host-computed in double, then cast to T, as grad_from_taps forms them).
template <typename T>
struct PkGradWeights {
  T wx[PK_H], wy[PK_H], wz[PK_H];
};

// grad per axis: acc = 0, then for s = 1..H acc + w * (tap(+s) - tap(-s)) --
// grad_from_taps term by term; out[d] is the derivative along axis d.
template <int PAD = 0, typename T, typename Load>
__device__ __forceinline__ void pk_grad(const Load& load, int x, int y,
                                        int z, int X, int Y, int Z,
                                        const PkGradWeights<T>& w,
                                        T (&out)[3]) {
  constexpr bool PX = PAD & PK_PAD_X, PY = PAD & PK_PAD_Y;
  constexpr bool PZ = PAD & PK_PAD_Z;
  T gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
  for (int s = 1; s <= PK_H; ++s) {
    gx = gx + w.wx[s - 1] * (load(pk_tap<PX>(x + s, X), y, z)
                             - load(pk_tap<PX>(x - s, X), y, z));
    gy = gy + w.wy[s - 1] * (load(x, pk_tap<PY>(y + s, Y), z)
                             - load(x, pk_tap<PY>(y - s, Y), z));
    gz = gz + w.wz[s - 1] * (load(x, y, pk_tap<PZ>(z + s, Z))
                             - load(x, y, pk_tap<PZ>(z - s, Z)));
  }
  out[0] = gx;
  out[1] = gy;
  out[2] = gz;
}

template <typename T>
static inline PkGradWeights<T> pk_grad_weights(const double* w) {
  PkGradWeights<T> out;
  for (int s = 0; s < PK_H; ++s) {
    out.wx[s] = T(w[s]);
    out.wy[s] = T(w[PK_H + s]);
    out.wz[s] = T(w[2 * PK_H + s]);
  }
  return out;
}

template <typename T>
static inline PkLapWeights<T> pk_lap_weights(const double* w) {
  PkLapWeights<T> out;
  out.w0 = T(w[0]);
  for (int s = 0; s < PK_H; ++s) {
    out.wx[s] = T(w[1 + s]);
    out.wy[s] = T(w[1 + PK_H + s]);
    out.wz[s] = T(w[1 + 2 * PK_H + s]);
  }
  return out;
}

// Number of Laplacian weights in a launch's params (gradient weights, for
// the GW variants, follow them: 3 * PK_H more).
#define PK_NLAPW (1 + 3 * PK_H)

// The lattice arrays of a launch, passed to the kernel by value: the C entry
// points take host arrays of pointers (in order: the scalar system's four,
// then, for the GW variants, the tensor system's four) and copy them here.
// Scalar arrays are (PK_F, X, Y, Z), tensor arrays (PK_NH, X, Y, Z).
#define PK_MAX_ARRAYS 8

template <typename T>
struct PkArrays {
  const T* in[PK_MAX_ARRAYS];
  T* out[PK_MAX_ARRAYS];
};

template <typename T>
static inline PkArrays<T> pk_arrays(const void* const* ins,
                                    void* const* outs, int n) {
  PkArrays<T> a;
  for (int k = 0; k < PK_MAX_ARRAYS; ++k) {
    a.in[k] = k < n ? (const T*)ins[k] : nullptr;
    a.out[k] = k < n ? (T*)outs[k] : nullptr;
  }
  return a;
}

// Array k of a launch as a pointer of storage type C: the same address,
// read or written as C. The carries (arrays 2, 3 and, for the GW variants,
// 6, 7) are stored in C; a new carry type is such a view of the same
// pointers, never a field of PkArrays.
template <typename C, typename T>
__device__ __forceinline__ const C* pk_in_as(const PkArrays<T>& io, int k) {
  return reinterpret_cast<const C*>(io.in[k]);
}

template <typename C, typename T>
__device__ __forceinline__ C* pk_out_as(const PkArrays<T>& io, int k) {
  return reinterpret_cast<C*>(io.out[k]);
}

// One thread per lattice site: z (the contiguous axis) is the fastest
// thread index, so a warp reads 32 neighbouring values of each array.
#define PK_BLOCK_Z 32
#define PK_BLOCK_Y 8

static inline dim3 pk_grid(int X, int Y, int Z) {
  return dim3((Z + PK_BLOCK_Z - 1) / PK_BLOCK_Z,
              (Y + PK_BLOCK_Y - 1) / PK_BLOCK_Y, X);
}

// The number of blocks of pk_grid: the partial sums of a lattice's sum
// kernels are indexed by its blocks (pk_march_sums).
extern "C" long long pk_num_blocks(int X, int Y, int Z) {
  const dim3 g = pk_grid(X, Y, Z);
  return (long long)g.x * g.y * g.z;
}

#ifdef PK_NH
// One 2N-storage stage of a tensor component at a site: the arithmetic of
// the JAX package's FusedPreheatStepper._gw_stage (pystella_tpu/ops/fused.py),
// kdh1 = A*kdh0 + dt*((lap_h - (2*hubble)*dh0) + (16 pi)*S_ij), 16 pi being
// the Python double cast to T. two_hub is T(2) * hubble.
template <typename T>
__device__ __forceinline__ void pk_gw_stage(T h0, T dh0, T kh0, T kdh0,
                                            T lap_h, T sij, T A, T B, T dt,
                                            T two_hub, T& h1, T& dh1, T& kh1,
                                            T& kdh1) {
  kh1 = A * kh0 + dt * dh0;
  h1 = h0 + B * kh1;
  kdh1 = A * kdh0 + dt * ((lap_h - two_hub * dh0) + T(PK_GW_COEF) * sij);
  dh1 = dh0 + B * kdh1;
}
#endif

// ---------------------------------------------------------------------------
// Deterministic lattice sums (the energy-emitting kernels K5, K6).
//
// The TPU kernels carry their sums across a sequential grid in a revisited
// accumulator tile (pallas_stencil.py:_accumulate_sums); blocks on the card
// run in no order, so a sum takes two launches and no atomics:
//
// 1. pk_march_sums (below, with the x-march): each 32 x 8 tile of a plane
//    reduces its 256 sites' terms in a fixed tree (a shuffle-down tree in
//    each warp, then the 8 warp sums pairwise) and writes one partial per
//    term into a (terms, blocks) buffer, at the index the tile's block has
//    in the per-site grid pk_grid;
// 2. pk_reduce_partials_kernel: one block per term sums that term's
//    partials in a fixed order (per thread, pairwise groups of 8 folded in
//    sequence; then a tree over the threads).
//
// The order depends on the lattice shape only, so two launches on the same
// inputs give bit-equal sums, and so do the padded launches of a sharded
// lattice whose partials land in one buffer at their unsharded indices. Sums
// are kept in T, as the JAX accumulator is.
// ---------------------------------------------------------------------------

// terms of one energy sum set: per component sum(dfdt^2), then per
// component sum(-f lap f), then sum(V)
#define PK_NT (2 * PK_F + 1)
#define PK_REDUCE_THREADS 1024

template <typename T>
__global__ void __launch_bounds__(PK_REDUCE_THREADS)
pk_reduce_partials_kernel(const T* __restrict__ partials,
                          T* __restrict__ sums, int64_t nblocks) {
  __shared__ T part[PK_REDUCE_THREADS];
  const T* p = partials + blockIdx.x * nblocks;
  T acc = T(0);
  for (int64_t base = (int64_t)threadIdx.x * 8; base < nblocks;
       base += (int64_t)PK_REDUCE_THREADS * 8) {
    T v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = base + j < nblocks ? p[base + j] : T(0);
    acc = acc + (((v[0] + v[1]) + (v[2] + v[3]))
                 + ((v[4] + v[5]) + (v[6] + v[7])));
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = PK_REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] = part[threadIdx.x]
                                             + part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = part[0];
}

// Second launch of a sum: the (nterms, nblocks) partials -> nterms sums.
template <typename T>
static int pk_finish_sums(void* partials, void* sums, int nterms,
                          int64_t nblocks, cudaStream_t stream) {
  pk_reduce_partials_kernel<T><<<nterms, PK_REDUCE_THREADS, 0, stream>>>(
      (const T*)partials, (T*)sums, nblocks);
  return (int)cudaGetLastError();
}

// The second launch as an entry point of the sources with sum kernels: the
// sharded tier runs it once, after the padded launches of every shard have
// written their partials.
#define PK_FINISH_ENTRIES                                                   \
  extern "C" int pk_finish_sums_f32(void* partials, void* sums, int nterms, \
                                    int64_t nblocks, void* stream) {        \
    return pk_finish_sums<float>(partials, sums, nterms, nblocks,           \
                                 (cudaStream_t)stream);                     \
  }                                                                         \
  extern "C" int pk_finish_sums_f64(void* partials, void* sums, int nterms, \
                                    int64_t nblocks, void* stream) {        \
    return pk_finish_sums<double>(partials, sums, nterms, nblocks,          \
                                  (cudaStream_t)stream);                    \
  }

// ---------------------------------------------------------------------------
// The geometry of an x-march tile (pk_march below, pk_queue_march, the march
// of fd_ops.cu's and mg_relax.cu's kernels, whose headers define no PK_F,
// and fd_lap's own): a block of 32 (z) x 8 (y) threads owns one y-z tile;
// per tapped
// array it holds the centre plane with its y-z halo (SY x SZ) and, in
// pk_march, a ring of 2h+1 planes of the tile itself (pk_queue_march keeps
// the +-x taps in registers).
// ---------------------------------------------------------------------------
// the most dynamic shared memory a block may use on sm_90
#define PK_MARCH_SMEM 232448

struct PkTileGeo {
  static constexpr int TZ = PK_BLOCK_Z, TY = PK_BLOCK_Y;
  static constexpr int THREADS = TZ * TY;
  static constexpr int SY = TY + 2 * PK_H, SZ = TZ + 2 * PK_H;
  static constexpr int NS = 2 * PK_H + 1;           // ring slots
  static constexpr int PLANE = TY * TZ;              // one ring slot
  static constexpr int CENTRE = SY * SZ;             // the haloed plane
  static constexpr int FRAME = CENTRE - PLANE;       // its halo
  static constexpr int SITES = CENTRE + NS * PLANE;  // one array's share
};

// Element k of the centre plane's halo frame, as (row, column) of the
// haloed plane: h rows above and below, then h columns on either side of
// each row.
__device__ __forceinline__ void pk_frame_at(int k, int& yy, int& zz) {
  using Tl = PkTileGeo;
  if (k < 2 * PK_H * Tl::SZ) {
    yy = k / Tl::SZ;
    zz = k % Tl::SZ;
    if (yy >= PK_H) yy += Tl::TY;
  } else {
    const int r = k - 2 * PK_H * Tl::SZ;
    yy = PK_H + r / (2 * PK_H);
    zz = r % (2 * PK_H);
    if (zz >= PK_H) zz += Tl::TZ;
  }
}

// ---------------------------------------------------------------------------
// The register-queue x-march (pk_queue_march): the TPU builder's x ring
// (StreamingStencil._build, pystella_tpu/ops/pallas_stencil.py:709, the ring
// :719-742) for kernels that tap NA arrays as they are, one value each:
// fd_grad, fd_grad_lap and fd_div (fd_ops.cu, NA = 1, 1 and 3; its fd_lap
// keeps its own loop of this design) and the multigrid sweeps (mg_relax.cu,
// NA = MG_NF). A block of 32 (z) x 8 (y) threads owns one y-z tile and
// walks it along x over a run of planes. Per tapped array the
// centre plane with its y-z halo sits in static shared memory (the y and z
// taps) and the +-x taps of a thread's own column in a queue of 2h+1 values
// in its registers (a ring of 2h+1 shared planes, as pk_march keeps, ran
// 16-19% slower for fd_lap on an H100). Every element is read from device
// memory about once (the y-z halo, mostly from L2, aside), and pk_lap /
// pk_grad run over the planes in box coordinates (PK_BOX): lap_from_taps'
// and grad_from_taps' order, so the march equals the per-site arithmetic
// bit for bit. Periodic wrap, or a padded window's rows, is resolved where a
// plane, row or column is loaded, so any shape runs (a run shorter than a
// kernel's, 2^3, the shells' (3h, Y, Z) windows).
// ---------------------------------------------------------------------------
// the most static shared memory a block may declare
#define PK_STATIC_SMEM 49152

// The tile of a queue march of NA tapped arrays in runs of LX planes: its
// static shared memory, NA haloed centre planes, and whether they fit.
template <typename T, int NA, int LX_>
struct PkQueueTile : PkTileGeo {
  static constexpr int LX = LX_;
  static constexpr int SMEM = NA * CENTRE * (int)sizeof(T);
  static constexpr bool FITS = SMEM <= PK_STATIC_SMEM;
};

// One tapped array around the thread's site, as pk_lap's and pk_grad's
// loader: box x = PK_H is the centre plane (any y, z of the haloed tile),
// another x the queue's value x - PK_H planes away at the thread's own
// (y, z).
template <typename T>
struct PkQueueLoad {
  const T* centre;
  T q[2 * PK_H + 1];
  __device__ __forceinline__ T operator()(int x, int y, int z) const {
    return x == PK_H ? centre[y * PkTileGeo::SZ + z] : q[x];
  }
};

// The window arrays a queue march taps: array a's value at window index i
// is p[a][i].
template <typename T, int NA>
struct PkQueueSrc {
  const T* p[NA];
};

// What a march's pre functor returns when a body reads nothing but the
// taps.
struct PkNoSite {};

// Lap and grad of one tapped array at the thread's site.
template <typename T>
__device__ __forceinline__ T pk_queue_lap(const PkQueueLoad<T>& col,
                                          const PkLapWeights<T>& w) {
  return pk_lap<PK_BOX>(col, col.q[PK_H], PK_H, (int)threadIdx.y + PK_H,
                        (int)threadIdx.x + PK_H, 0, 0, 0, w);
}

template <typename T>
__device__ __forceinline__ void pk_queue_grad(const PkQueueLoad<T>& col,
                                              const PkGradWeights<T>& w,
                                              T (&out)[3]) {
  pk_grad<PK_BOX>(col, PK_H, (int)threadIdx.y + PK_H,
                  (int)threadIdx.x + PK_H, 0, 0, 0, w, out);
}

// The march of one block over planes xs .. xs + nx - 1 of an (X, Y, Z)
// region, window y extent Yw, padded along PAD's axes (a plane of a padded x
// window lies in [-h, X + h)). Per plane and thread (valid site or not):
// the queues' new values, this thread's first frame element of each
// centre plane and pre(x), the site's own values a body reads from device
// memory, are loaded together and stored; after a barrier body(x, col,
// pre's result) runs, col the NA loaders; a barrier ends the step. AHEAD:
// those loads are issued a step ahead, so each step stores the loads the
// step before issued and they are in flight across its barriers and body.
// HALO: per tapped array a, bit 2a loads the rows of its centre plane's
// frame (h above and below the tile, corners included) and bit 2a + 1 its
// columns (h either side of each row); an array with neither is tapped
// through its queue alone, and its centre plane is not stored either. Every
// bit set (the default): the full frames.
template <typename T, int NA, int PAD, bool AHEAD, unsigned HALO = ~0u,
          typename Pre, typename Body>
__device__ __forceinline__ void pk_queue_march(const PkQueueSrc<T, NA> src,
                                               int X, int Y, int Z, int Yw,
                                               int xs, int nx, Pre&& pre,
                                               Body&& body) {
  using Tl = PkTileGeo;
  __shared__ T sm[NA * Tl::CENTRE];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int own = ty * Tl::TZ + tz;
  const int z0 = blockIdx.x * Tl::TZ, y0 = blockIdx.y * Tl::TY;
  const int z = z0 + tz, y = y0 + ty;
  const T* __restrict__ p[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) p[a] = src.p[a];
  // array a's window value at point (x, yy, zz) of the region; a tile
  // hanging past a padded window's last row reads that row (no valid site
  // taps it)
  auto at = [&](int a, int x, int yy, int zz) {
    if (!(PAD & PK_PAD_X)) x = pk_wrap(x, X);
    yy = (PAD & PK_PAD_Y) ? min(yy, Y + PK_H - 1) : pk_wrap(yy, Y);
    return p[a][((int64_t)x * Yw + yy) * Z + pk_wrap(zz, Z)];
  };
  const int ctr = (ty + PK_H) * Tl::SZ + tz + PK_H;
  // whether array a stores its centre plane, and loads frame element k
  auto planed = [](int a) {
    if constexpr (HALO == ~0u) return true;
    else return ((HALO >> (2 * a)) & 3u) != 0;
  };
  auto framed = [](int a, int k) {
    if constexpr (HALO == ~0u) return true;
    else return ((HALO >> (2 * a + (k < 2 * PK_H * Tl::SZ ? 0 : 1))) & 1u)
                != 0;
  };
  // this thread's first frame element, at the same place every plane
  const bool first = own < Tl::FRAME;
  int fy = 0, fz = 0;
  if (first) pk_frame_at(own, fy, fz);
  // planes xs - h .. xs + h - 1 of the thread's column: the queues' 1 ..
  // 2h; then plane xs + h and the first plane's frame element
  PkQueueLoad<T> col[NA];
  T next[NA], edge[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    col[a] = PkQueueLoad<T>{sm + a * Tl::CENTRE, {}};
#pragma unroll
    for (int k = 0; k < 2 * PK_H; ++k)
      col[a].q[k + 1] = at(a, xs - PK_H + k, y, z);
  }
  decltype(pre(xs)) site{};
  if constexpr (AHEAD) {
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      next[a] = at(a, xs + PK_H, y, z);
      edge[a] = first && framed(a, own)
                    ? at(a, xs, y0 - PK_H + fy, z0 - PK_H + fz) : T(0);
    }
    site = pre(xs);
  }
  for (int i = 0; i < nx; ++i) {
    const int x = xs + i;
    if constexpr (!AHEAD) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        next[a] = at(a, x + PK_H, y, z);
        if (first && framed(a, own))
          edge[a] = at(a, x, y0 - PK_H + fy, z0 - PK_H + fz);
      }
    }
    const auto cur = AHEAD ? site : pre(x);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      T* const q = col[a].q;
#pragma unroll
      for (int k = 0; k < 2 * PK_H; ++k) q[k] = q[k + 1];
      q[2 * PK_H] = next[a];
      if (planed(a)) sm[a * Tl::CENTRE + ctr] = q[PK_H];
      if (first && framed(a, own))
        sm[a * Tl::CENTRE + fy * Tl::SZ + fz] = edge[a];
    }
    if (AHEAD && i + 1 < nx) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        next[a] = at(a, x + PK_H + 1, y, z);
        if (first && framed(a, own))
          edge[a] = at(a, x + 1, y0 - PK_H + fy, z0 - PK_H + fz);
      }
      site = pre(x + 1);
    }
    // the rest of the frame (h >= 3: more elements than threads)
    for (int k = own + Tl::THREADS; k < Tl::FRAME; k += Tl::THREADS) {
      int yy, zz;
      pk_frame_at(k, yy, zz);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        if (framed(a, k))
          sm[a * Tl::CENTRE + yy * Tl::SZ + zz] =
              at(a, x, y0 - PK_H + yy, z0 - PK_H + zz);
    }
    __syncthreads();
    body(x, (const PkQueueLoad<T>(&)[NA])col, cur);
    __syncthreads();
  }
}

#ifdef PK_F
// ---------------------------------------------------------------------------
// The x-march of the pair kernels -- K3 and K6 with NH = 0 tensor
// components, the GW pairs K8 and K9 with NH = PK_NH: the streaming design
// of the TPU builder StreamingStencil._build (pystella_tpu/ops/
// pallas_stencil.py:709; its x ring of planes, :719-742) carried to a
// thread block. (The fused sources only: the model header defines PK_F.)
//
// A block of 32 (z) x 8 (y) threads owns one y-z tile and walks it along x
// over a run of LX planes. Its dynamic shared memory holds, per tapped
// array -- f and the stage-1 field f1 of a scalar component, h and h1 of a
// tensor component --
//  - a ring of 2h+1 planes of the tile itself (the +-x taps of a thread's
//    own column; a thread reads only its own column of the ring);
//  - the centre plane with its y-z halo (the y and z taps);
// and the budget leaves room for K6's and K9's static per-warp partials of
// one plane's sums (pk_march_sums).
// Each step brings plane x+h into the ring (where x-h-1 was), copies plane
// x from the ring into the centre plane and loads that plane's halo frame.
// f1 = f + B1*(A1*kf + dt*dfdt) and h1 are composed as an element is
// loaded, once (PkMarchInputs::composed; the velocity completed first for
// a deferred input), so every tap reads the value the first stage alone
// would have stored. Lap and grad run pk_lap / pk_grad over the shared
// planes in box coordinates (PK_BOX), so their accumulation order stays
// lap_from_taps' and grad_from_taps'. Periodic
// wrap, or a padded window's rows, is resolved where a plane, row or
// column is loaded.
//
// A block marches its run once per pass, of one of two layouts:
//  - joint, where every field fits beside a group of G tensor components
//    (NH = 0: where every field fits): each pass holds f, f1 of every
//    field and h, h1 of G components, G the first of NH, 3, 2, 1 that
//    divides NH and fits; the scalar stage and the sums run in the first
//    pass (NH = 0: the only one), S_ij from the shared planes in each;
//  - split, otherwise: first the scalar passes, each holding GF fields
//    (the most that fit; the last pass the rest), which run the scalar
//    stage of their fields and emit their sum terms (and, with tensors,
//    park their gradients of both stages in a thread-local buffer of the
//    run); then the tensor passes, each holding G components (G as above,
//    alone), with S_ij from that buffer.
// Every value is the joint march's, so both give the per-site arithmetic's
// outputs bit for bit. A block may hold the most dynamic shared memory
// sm_90 gives one (PK_MARCH_SMEM); ops/fused.py:march_tile mirrors the
// rule; pk_scalar_march_tile and pk_preheat_march_tile report the
// instantiated tiles.
//
// The single stages of fused_stage.cu that march (pk_stage_march_kernel:
// the GW energy stage K5', the GW stage K7 and the scalar energy stage K5)
// march the same way with one value per tapped array (V = 1): f of each
// field, h of each component (NH = 0 for K5), and no stage-1 composition;
// their tile follows the same rule with one array where the pairs hold two
// (pk_stage_march_tile and pk_scalar_stage_march_tile report it).
// ---------------------------------------------------------------------------
// x planes a run of K8 and K9, of K3 and K6, of the GW stage march (K5',
// K7) and of the scalar one (K5): the fastest variants of chip_smoke.py
// --phases march_variants on an H100
#ifndef PK_MARCH_LX
#define PK_MARCH_LX 32
#endif
#ifndef PK_SCALAR_MARCH_LX
#define PK_SCALAR_MARCH_LX 24
#endif
#ifndef PK_STAGE_MARCH_LX
#define PK_STAGE_MARCH_LX 16
#endif
#ifndef PK_SCALAR_STAGE_MARCH_LX
#define PK_SCALAR_STAGE_MARCH_LX 32
#endif

// The geometry of a march tile, whatever it holds, and the room it leaves
// for K6's and K9's warp partials.
struct PkMarchGeo : PkTileGeo {
  static constexpr int NSUM = 2 * PK_NT * TY;        // K6's, K9's partials
};

// The tile of a march with NH tensor components (0: the scalar march) and
// V values per tapped array (2: the pairs' f and f1, h and h1; 1: the
// stage march).
template <typename T, int NH, int V = 2>
struct PkMarchTile : PkMarchGeo {
  static constexpr int LX =
      V == 1 ? (NH ? PK_STAGE_MARCH_LX : PK_SCALAR_STAGE_MARCH_LX)
             : NH ? PK_MARCH_LX : PK_SCALAR_MARCH_LX;
  // dynamic (the arrays) and static (the warp partials) shared memory fit
  static constexpr bool fits(int arrays) {
    return ((long long)arrays * SITES + NSUM) * (long long)sizeof(T)
           <= PK_MARCH_SMEM;
  }
  // the tensor components a pass holds beside `arrays` scalar arrays
  static constexpr int tensors(int arrays) {
    const int cand[4] = {NH, 3, 2, 1};
    for (int k = 0; k < 4; ++k)
      if (cand[k] > 0 && cand[k] <= NH && NH % cand[k] == 0
          && fits(arrays + V * cand[k]))
        return cand[k];
    return 0;
  }
  // the most fields a scalar pass of the split layout holds
  static constexpr int fields() {
    int k = PK_F;
    while (k > 0 && !fits(V * k)) --k;
    return k;
  }
  static constexpr bool JOINT = NH ? tensors(V * PK_F) > 0 : fits(V * PK_F);
  static constexpr int G = !NH ? 0 : JOINT ? tensors(V * PK_F) : tensors(0);
  static constexpr int GF = JOINT ? PK_F : fields();
  static constexpr int HS = JOINT ? V * PK_F : 0;  // a pass's first h array
  static constexpr int NA =                        // arrays in shared memory
      JOINT ? V * PK_F + V * G : (GF > G ? V * GF : V * G);
  static constexpr int NSP = JOINT ? 0 : (PK_F + GF - 1) / GF;
  static constexpr int PASSES = NSP + (NH ? NH / G : JOINT);
  static constexpr int SMEM = NA * SITES * (int)sizeof(T);  // dynamic
};

// Pass p of a march: the fields [k0, k0 + nf) and the tensor components
// [c0, c0 + ng) it holds; scalar: it runs the scalar stage (and the sums)
// of its fields. The joint layout's answers are spelled out as constants,
// and the kernels take a pass by value: where the compiler could not fold
// them (or read them through a reference), K8 and K9 kept fewer of a
// plane's loads in flight and ran slower.
template <typename T, int NH, int V = 2>
struct PkMarchPass {
  using Tl = PkMarchTile<T, NH, V>;
  int p, k0, nf, c0, ng;
  bool scalar;
  __device__ __forceinline__ explicit PkMarchPass(int p_) : p(p_) {
    c0 = Tl::G == NH ? 0 : (p - Tl::NSP) * Tl::G;
    k0 = Tl::JOINT ? 0 : p * Tl::GF;
    nf = Tl::JOINT ? PK_F : (p < Tl::NSP ? min(Tl::GF, PK_F - k0) : 0);
    ng = Tl::JOINT || p >= Tl::NSP ? Tl::G : 0;
    scalar = Tl::JOINT ? p == 0 : p < Tl::NSP;
  }
  // field c is one the pass holds
  __device__ __forceinline__ bool held(int c) const {
    return Tl::JOINT || (c >= k0 && c < k0 + nf);
  }
  __device__ __forceinline__ bool tensors() const {
    return NH > 0 && (Tl::JOINT || ng > 0);
  }
  // the pass writes sum term t of a scalar pass (PK_NT a set: dfdt^2 and
  // -f lap f per field, then V): its fields' terms, V in the first pass
  __device__ __forceinline__ bool sums(int t) const {
    const int u = t % PK_NT;
    return Tl::JOINT
           || (u == 2 * PK_F ? p == 0 : held(u < PK_F ? u : u - PK_F));
  }
};

// One tapped array around the thread's site, in box coordinates: x = PK_H
// is the centre plane (any y, z of the haloed tile), another x the ring
// plane x - PK_H away, at the thread's own (y, z).
template <typename T>
struct PkMarchLoad {
  const T* centre;  // the array's haloed centre plane
  const T* ring;    // its ring slot 0, at the thread's own site
  int s0;           // the ring slot of box x = 0 (plane x - PK_H)
  __device__ __forceinline__ T operator()(int x, int y, int z) const {
    using Tl = PkMarchGeo;
    if (x == PK_H) return centre[y * Tl::SZ + z];
    int s = s0 + x;
    if (s >= Tl::NS) s -= Tl::NS;
    return ring[s * Tl::PLANE];
  }
};

// The raw window arrays the march composes from, per system (0: scalar,
// 1: tensor): the field, the velocity, the field carry and, for a deferred
// input, the velocity carry (kdfp, kdhp) that completes the velocity; and
// the stage-1 scalars.
template <typename T, typename C, bool IN_DEFERRED>
struct PkMarchInputs {
  const T* fld[2];
  const T* vel[2];
  const C* kf[2];
  const C* kv[2];
  T B1, A1, dt, B2p, c_def;
  // the stage-1 field at window index i, where the field is fv: fv + B1 *
  // (A1 * kf + dt * v), the arithmetic of the JAX package's _axpy_taps
  // (pystella_tpu/ops/fused.py); for a deferred input the velocity v =
  // dfp + B2p * (kdfp - c_def * dfp) with c_def = (2 * dt) * hubfix, that
  // of its _completed_taps. The carries are stored in C and widened.
  __device__ __forceinline__ T composed(int sys, int64_t i, T fv) const {
    T d = vel[sys][i];
    if (IN_DEFERRED)
      d = d + B2p * (PkCarry<T, C>::load(kv[sys][i]) - c_def * d);
    return fv + B1 * (A1 * PkCarry<T, C>::load(kf[sys][i]) + dt * d);
  }
};

// The view of a block's shared planes its per-site body reads: array a's
// loader around the thread's site.
template <typename T>
struct PkMarchView {
  const T* sm;
  int own;  // the thread's site in a ring slot
  int s0;
  __device__ __forceinline__ PkMarchLoad<T> operator()(int a) const {
    using Tl = PkMarchGeo;
    const T* base = sm + a * Tl::SITES;
    return PkMarchLoad<T>{base, base + Tl::CENTRE + own, s0};
  }
};

// Lap and grad of array a at the thread's site from the shared planes.
template <typename T>
__device__ __forceinline__ T pk_march_lap(const PkMarchView<T>& v, int a,
                                          T centre,
                                          const PkLapWeights<T>& w) {
  return pk_lap<PK_BOX>(v(a), centre, PK_H, (int)threadIdx.y + PK_H,
                        (int)threadIdx.x + PK_H, 0, 0, 0, w);
}

template <typename T>
__device__ __forceinline__ void pk_march_grad(const PkMarchView<T>& v, int a,
                                              const PkGradWeights<T>& w,
                                              T (&out)[3]) {
  pk_grad<PK_BOX>(v(a), PK_H, (int)threadIdx.y + PK_H,
                  (int)threadIdx.x + PK_H, 0, 0, 0, w, out);
}

// The march of one block (see above). Per pass, plane x of the block's run
// (the i-th) and thread of the block (valid site or not): the plane's
// loads -- the ring's new plane, the centre plane's halo frame and pre(x,
// pass), the site's own values a body reads from device memory -- are
// issued together, the composed values stored, and after a barrier
// body(x, i, pass, view, pre's result) runs; a barrier ends the step.
// Window inputs are read with component stride Nw and y extent Yw, padded
// along PAD's axes (a plane of a padded x window lies in [-h, X + h)).
// With V = 1 a tapped array holds the window's values as they are. AHEAD
// (the scalar energy stage K5): the ring's next plane and the first frame
// element are loaded a step ahead, as fd_ops.cu's march loads its planes.
template <typename T, int NH, int PAD, int V = 2, bool AHEAD = false,
          typename In, typename Pre, typename Body>
__device__ __forceinline__ void pk_march(const In& in, int X, int Y, int Z,
                                         int64_t Nw, int Yw, Pre&& pre,
                                         Body&& body) {
  using Tl = PkMarchTile<T, NH, V>;
  static_assert((NH == 0 || Tl::G > 0) && Tl::GF > 0,
                "no x-march tile fits a block's shared memory");
  extern __shared__ __align__(16) unsigned char pk_march_smem[];
  T* const sm = reinterpret_cast<T*>(pk_march_smem);
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int own = ty * Tl::TZ + tz;
  const int z0 = blockIdx.x * Tl::TZ, y0 = blockIdx.y * Tl::TY;
  const int xs = blockIdx.z * Tl::LX;
  const int nx = min(Tl::LX, X - xs);
  auto put = [&](const T (&v)[Tl::NA], int pos) {
#pragma unroll
    for (int a = 0; a < Tl::NA; ++a) sm[a * Tl::SITES + pos] = v[a];
  };

  for (int pass = 0; pass < Tl::PASSES; ++pass) {
    const PkMarchPass<T, NH, V> ps(pass);
    // the tapped arrays the pass holds at lattice point (x, y, z) of the
    // region, composed into v. A tile hanging past a padded window's last
    // row (y >= Y + h) feeds no valid site's taps, so it reads the last
    // row instead: the loads stay unconditional
    auto gather = [&](int x, int y, int z, T (&v)[Tl::NA]) {
      if (!(PAD & PK_PAD_X)) x = pk_wrap(x, X);
      y = (PAD & PK_PAD_Y) ? min(y, Y + PK_H - 1) : pk_wrap(y, Y);
      const int64_t w = ((int64_t)x * Yw + y) * Z + pk_wrap(z, Z);
#pragma unroll
      for (int j = 0; j < Tl::GF; ++j) {
        if (ps.held(ps.k0 + j)) {
          const int64_t i = (ps.k0 + j) * Nw + w;
          v[j] = in.fld[0][i];
          if constexpr (V == 2) v[Tl::GF + j] = in.composed(0, i, v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < Tl::G; ++j) {
        if (ps.tensors()) {
          const int64_t i = (ps.c0 + j) * Nw + w;
          v[Tl::HS + j] = in.fld[1][i];
          if constexpr (V == 2)
            v[Tl::HS + Tl::G + j] = in.composed(1, i, v[Tl::HS + j]);
        }
      }
    };
    // the ring: planes xs - h .. xs + h - 1 in slots 0 .. 2h - 1
    for (int q = 0; q < 2 * PK_H; ++q) {
      T v[Tl::NA];
      gather(xs - PK_H + q, y0 + ty, z0 + tz, v);
      put(v, Tl::CENTRE + q * Tl::PLANE + own);
    }
    if constexpr (AHEAD) {
      // plane x + h for the ring and this thread's first frame element of
      // plane x, loaded a step ahead: each step stores the loads the step
      // before issued and issues the next plane's, so they are in flight
      // across the step's barriers and body
      const bool first = own < Tl::FRAME;
      int fy = 0, fz = 0;
      if (first) pk_frame_at(own, fy, fz);
      T ring[Tl::NA], edge[Tl::NA];
      gather(xs + PK_H, y0 + ty, z0 + tz, ring);
      if (first) gather(xs, y0 - PK_H + fy, z0 - PK_H + fz, edge);
      for (int i = 0; i < nx; ++i) {
        const int x = xs + i;
        const auto site = pre(x, ps);
        put(ring, Tl::CENTRE + ((i + 2 * PK_H) % Tl::NS) * Tl::PLANE + own);
        {
          const int src = Tl::CENTRE + ((i + PK_H) % Tl::NS) * Tl::PLANE
                          + own;
          const int dst = (ty + PK_H) * Tl::SZ + tz + PK_H;
#pragma unroll
          for (int a = 0; a < Tl::NA; ++a)
            sm[a * Tl::SITES + dst] = sm[a * Tl::SITES + src];
        }
        if (first) put(edge, fy * Tl::SZ + fz);
        if (i + 1 < nx) {
          gather(x + 1 + PK_H, y0 + ty, z0 + tz, ring);
          if (first) gather(x + 1, y0 - PK_H + fy, z0 - PK_H + fz, edge);
        }
        for (int k = own + Tl::THREADS; k < Tl::FRAME; k += Tl::THREADS) {
          int yy, zz;
          T v[Tl::NA];
          pk_frame_at(k, yy, zz);
          gather(x, y0 - PK_H + yy, z0 - PK_H + zz, v);
          put(v, yy * Tl::SZ + zz);
        }
        __syncthreads();
        body(x, i, ps, PkMarchView<T>{sm, own, i % Tl::NS}, site);
        __syncthreads();
      }
      continue;
    }
    for (int i = 0; i < nx; ++i) {
      const int x = xs + i;
      // plane x + h for the ring, the first frame element of this thread,
      // the site's own values: all loads in flight together
      T ring[Tl::NA], edge[Tl::NA];
      gather(x + PK_H, y0 + ty, z0 + tz, ring);
      int yy = 0, zz = 0;
      const bool first = own < Tl::FRAME;
      if (first) {
        pk_frame_at(own, yy, zz);
        gather(x, y0 - PK_H + yy, z0 - PK_H + zz, edge);
      }
      const auto site = pre(x, ps);
      put(ring, Tl::CENTRE + ((i + 2 * PK_H) % Tl::NS) * Tl::PLANE + own);
      {
        // plane x from the ring into the centre plane
        const int src = Tl::CENTRE + ((i + PK_H) % Tl::NS) * Tl::PLANE + own;
        const int dst = (ty + PK_H) * Tl::SZ + tz + PK_H;
#pragma unroll
        for (int a = 0; a < Tl::NA; ++a)
          sm[a * Tl::SITES + dst] = sm[a * Tl::SITES + src];
      }
      if (first) put(edge, yy * Tl::SZ + zz);
      for (int k = own + Tl::THREADS; k < Tl::FRAME; k += Tl::THREADS) {
        pk_frame_at(k, yy, zz);
        gather(x, y0 - PK_H + yy, z0 - PK_H + zz, edge);
        put(edge, yy * Tl::SZ + zz);
      }
      __syncthreads();
      body(x, i, ps, PkMarchView<T>{sm, own, i % Tl::NS}, site);
      __syncthreads();
    }
  }
}

// The sums of one plane of a march: the block's 32 x 8 tile reduced in a
// fixed tree (each warp a shuffle-down tree over its row, then the 8 rows
// pairwise), each term t that keep(t) selects
// written at the index the tile has in the per-site launch over the whole
// lattice:
// plane x0 + x, y block yb0 + blockIdx.y, GYb y blocks (PkGeom; the launch
// passes x0 = yb0 = 0 and GYb = ceil(Y / 8) unpadded). So the partials,
// and the sums, are those of a per-site launch (one 32 x 8 block a plane)
// bit for bit. Every thread of the block calls it.
template <typename T, int NT, typename Keep>
__device__ __forceinline__ void pk_march_sums(T (&v)[NT],
                                              T* __restrict__ partials,
                                              int64_t nblocks,
                                              const PkGeom& g, int x,
                                              Keep&& keep) {
  static_assert(PK_BLOCK_Z == 32 && PK_BLOCK_Y == 8,
                "one warp per y row of the tile, 8 warps a block");
  static_assert(NT * PK_BLOCK_Y <= PkMarchGeo::NSUM,
                "the warp partials' room in the march's budget");
  __shared__ T warp_sums[NT][PK_BLOCK_Y];
  const int lane = threadIdx.x, warp = threadIdx.y;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[t] = v[t] + __shfl_down_sync(0xffffffffu, v[t], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < NT; ++t) warp_sums[t][warp] = v[t];
  }
  __syncthreads();
  const int t = warp * PK_BLOCK_Z + lane;
  if (t < NT && keep(t)) {
    const T* w = warp_sums[t];
    partials[t * nblocks
             + ((int64_t)(g.x0 + x) * g.GYb + g.yb0 + blockIdx.y) * gridDim.x
             + blockIdx.x] =
        ((w[0] + w[1]) + (w[2] + w[3])) + ((w[4] + w[5]) + (w[6] + w[7]));
  }
}

// Launch a march kernel with NH tensor components (and V values per
// tapped array) over an (X, Y, Z) region: one block per y-z tile and run
// of LX planes, the tile's shared memory allowed first. Returns the
// launch's CUDA error.
template <typename T, int NH, int V = 2, typename... P, typename... A>
static int pk_march_launch(void (*kernel)(P...), int X, int Y, int Z,
                           void* stream, A... args) {
  using Tl = PkMarchTile<T, NH, V>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((Z + Tl::TZ - 1) / Tl::TZ, (Y + Tl::TY - 1) / Tl::TY,
                  (X + Tl::LX - 1) / Tl::LX);
  kernel<<<grid, dim3(Tl::TZ, Tl::TY, 1), Tl::SMEM,
           (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int NH, int V = 2>
static int pk_march_report(int* out) {
  using Tl = PkMarchTile<T, NH, V>;
  out[0] = Tl::LX;
  out[1] = Tl::GF;
  out[2] = Tl::G;
  out[3] = Tl::JOINT;
  out[4] = Tl::SMEM;
  return 0;
}

// The march tile of the float (f64 = 0) or double (f64 = 1) kernels: out =
// {x planes a run, fields a scalar pass holds, tensor components a pass
// holds, 1 for the joint layout or 0 for the split one, dynamic shared
// memory a block in bytes}. Returns 0. The scalar march's (K3, K6) is an
// entry point of their sources in every build.
#define PK_SCALAR_MARCH_ENTRY                                             \
  extern "C" int pk_scalar_march_tile(int f64, int* out) {                \
    return f64 ? pk_march_report<double, 0>(out)                          \
               : pk_march_report<float, 0>(out);                          \
  }

// The scalar energy stage's (K5: one value per tapped array, no tensor
// component), in the same form; an entry point of fused_stage.cu in every
// build.
#define PK_SCALAR_STAGE_MARCH_ENTRY                                       \
  extern "C" int pk_scalar_stage_march_tile(int f64, int* out) {          \
    return f64 ? pk_march_report<double, 0, 1>(out)                       \
               : pk_march_report<float, 0, 1>(out);                       \
  }

#ifdef PK_NH
// The GW pairs' (K8, K9).
extern "C" int pk_preheat_march_tile(int f64, int* out) {
  return f64 ? pk_march_report<double, PK_NH>(out)
             : pk_march_report<float, PK_NH>(out);
}

// The GW stages' (K5' and K7, one value per tapped array), in the same
// form; an entry point of fused_stage.cu.
#define PK_STAGE_MARCH_ENTRY                                              \
  extern "C" int pk_stage_march_tile(int f64, int* out) {                 \
    return f64 ? pk_march_report<double, PK_NH, 1>(out)                   \
               : pk_march_report<float, PK_NH, 1>(out);                   \
  }
#endif
#endif
