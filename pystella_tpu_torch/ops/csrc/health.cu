// K15 `health`: the numerics sentinel's per-field statistics, max|x| and
// sum(x^2), in one read of the state, and the finish launch that turns
// their row partials into the health vector's field slots.
//
// The JAX package has no Pallas kernel here: Sentinel.compute reduces each
// field with one variadic jax.lax.reduce (max|x| and sum of squares, in the
// field's dtype; _max_abs_and_mean_sq, pystella_tpu/obs/sentinel.py:79-99),
// which XLA fuses into one read. The plain PyTorch version takes several
// passes a field (abs, amax, square, sum and their temporaries), so the
// port reads each field once with this kernel.
//
// Units. A row is one z-row of Z contiguous elements of a C-ordered
// (outer, X, Y, Z) field (or of a block of one); a unit is one x-plane times
// a run of ry y-rows (ry = unit_rows(Y) of ops/histogram.py, 32 at 512^3,
// as K13's units). One block reduces one unit: each warp a row at a time
// (warp w the rows w, w + 8, ... of the unit, in order), then the block's
// warps in warp order, and writes one partial of each statistic at the
// unit's global index (c * X + x) * (Y / ry) + y / ry. A launch on a block
// of a sharded field (its y-extent a multiple of ry) writes only its own
// units, at their global places, and one finish launch reduces every
// field's units in one fixed order: a sharded state gives the single-device
// vector bit for bit. This is the partial-and-finish convention of the sum
// kernels in pk_common.cuh (pk_march_sums, pk_reduce_partials_kernel),
// whose order the finish below repeats.
//
// A row's order depends only on its contents: element e belongs to lane
// (e / V) % 32, V the elements of a 16-byte vector (4 f32, 2 f64, 8 bf16),
// and each lane takes its elements in increasing e; then a shuffle-down
// tree (16, 8, 4, 2, 1) over the lanes. A unit's order depends only on its
// rows and ry. Rows of a launch whose first
// element is 16-byte aligned and whose length is a multiple of V read in
// 16-byte vectors, four a lane in flight; other launches read the same
// elements one at a time, in the same order.
//
// Per element: |x| into a NaN-propagating max in the field's type, widened
// to float64 (exactly) once a row (a NaN makes the max NaN, as
// torch.amax and jnp.max do), x * x formed in the field's dtype (as
// jnp.square: a bf16 square rounded to bf16, an f32 square that overflows
// is +inf) and added in float64. The finish divides each sum by the field's
// element count in float64 (an IEEE division) and writes, per field, the
// finite flag isfinite(max) && !isnan(mean) (Sentinel.compute,
// sentinel.py:180-193: an overflowing square is not divergence, a NaN always
// poisons the sum), the max and sqrt(mean), in the vector's dtype.
//
// Bound: bytes. Each field is read once; the partials (two float64 a unit,
// 16 bytes per ry * Z elements) are written once and read once by the
// finish.

#include <math.h>
#include <string.h>

#include "pk_common.cuh"

#define PK_HEALTH_THREADS 256
#define PK_HEALTH_WARPS (PK_HEALTH_THREADS / 32)
// 16-byte vectors a lane keeps in flight
#define PK_HEALTH_AHEAD 4
// fields one finish launch takes
#define PK_HEALTH_MAX_FIELDS 32

template <class R>
__device__ __forceinline__ R pk_nanmax(R a, R b) {
  return (b > a || b != b) ? b : a;
}

// the element types: a 16-byte vector, its elements as float/double
// values, |x| and x * x in the field's dtype
template <class T>
struct PkHealthType;

template <>
struct PkHealthType<float> {
  typedef float4 Vec;
  typedef float Elem;
  static constexpr int V = 4;
  __device__ static float value(Elem e) { return e; }
  __device__ static float square(float x) { return x * x; }
  __device__ static void unpack(const Vec& v, float* out) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct PkHealthType<double> {
  typedef double2 Vec;
  typedef double Elem;
  static constexpr int V = 2;
  __device__ static double value(Elem e) { return e; }
  __device__ static double square(double x) { return x * x; }
  __device__ static void unpack(const Vec& v, double* out) {
    out[0] = v.x; out[1] = v.y;
  }
};

// bfloat16: the bits widened exactly to float; the square of two bf16
// values is exact in float and rounded once to bf16
__device__ __forceinline__ float pk_bf16_bits(unsigned bits) {
  const unsigned w = bits << 16;
  float f;
  memcpy(&f, &w, 4);
  return f;
}

template <>
struct PkHealthType<__nv_bfloat16> {
  typedef int4 Vec;
  typedef unsigned short Elem;
  static constexpr int V = 8;
  __device__ static float value(Elem e) { return pk_bf16_bits(e); }
  __device__ static float square(float x) {
    return __bfloat162float(__float2bfloat16_rn(x * x));
  }
  __device__ static void unpack(const Vec& v, float* out) {
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = pk_bf16_bits((unsigned)w[i] & 0xffffu);
      out[2 * i + 1] = pk_bf16_bits((unsigned)w[i] >> 16);
    }
  }
};

// one element into a lane's max (in the element's type) and sum
template <class H, class R>
__device__ __forceinline__ void pk_health_add(R x, R& m, double& s) {
  m = pk_nanmax(m, (R)fabs(x));
  s += (double)H::square(x);
}

// the type a field's elements are read as: float for f32 and bf16
template <class T>
using PkHealthR = decltype(PkHealthType<T>::value(
    typename PkHealthType<T>::Elem()));

// one row of Z elements by one warp: the lane's max and sum, then the tree
// over the lanes (lane 0 holds the row's)
template <class T, bool VEC>
__device__ __forceinline__ void pk_health_row(const T* row, int Z, int lane,
                                              PkHealthR<T>& m, double& s) {
  typedef PkHealthType<T> H;
  typedef PkHealthR<T> R;
  constexpr int V = H::V;
  const int ng = (Z + V - 1) / V;
  const typename H::Elem* e = (const typename H::Elem*)row;
  for (int g0 = 0; g0 < ng; g0 += 32 * PK_HEALTH_AHEAD) {
    if (VEC) {
      typename H::Vec v[PK_HEALTH_AHEAD];
#pragma unroll
      for (int k = 0; k < PK_HEALTH_AHEAD; ++k) {
        const int g = g0 + lane + 32 * k;
        if (g < ng) v[k] = ((const typename H::Vec*)row)[g];
      }
#pragma unroll
      for (int k = 0; k < PK_HEALTH_AHEAD; ++k) {
        const int g = g0 + lane + 32 * k;
        if (g < ng) {
          R x[V];
          H::unpack(v[k], x);
#pragma unroll
          for (int i = 0; i < V; ++i) pk_health_add<H>(x[i], m, s);
        }
      }
    } else {
      for (int k = 0; k < PK_HEALTH_AHEAD; ++k) {
        const int g = g0 + lane + 32 * k;
        for (int i = 0; i < V && g < ng && g * V + i < Z; ++i)
          pk_health_add<H>(H::value(e[g * V + i]), m, s);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    m = pk_nanmax(m, __shfl_down_sync(0xffffffffu, m, o));
    s = s + __shfl_down_sync(0xffffffffu, s, o);
  }
}

// The main launch: every unit of one block of one field. Block units are
// (c, lx, lu) over (nouter, bx, by / ry); the unit's global index is
// base + (c * X + x0 + lx) * (Y / ry) + y0 / ry + lu.
template <class T, bool VEC>
__global__ void __launch_bounds__(PK_HEALTH_THREADS)
pk_health_kernel(const T* __restrict__ x, double* __restrict__ pmax,
                 double* __restrict__ psum, long long nunits, int ry, int bx,
                 int by, int Z, int X, int Y, int x0, int y0,
                 long long base) {
  typedef PkHealthR<T> R;
  __shared__ R wm[PK_HEALTH_WARPS];
  __shared__ double ws[PK_HEALTH_WARPS];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int nyr = by / ry;
  for (long long u = blockIdx.x; u < nunits; u += gridDim.x) {
    const long long lu = u % nyr, lx = (u / nyr) % bx, c = u / nyr / bx;
    const T* unit = x + ((c * bx + lx) * by + lu * ry) * Z;
    R mw = R(0);
    double sw = 0.0;
    for (int j = w; j < ry; j += PK_HEALTH_WARPS) {
      R m = R(0);
      double s = 0.0;
      pk_health_row<T, VEC>(unit + (long long)j * Z, Z, lane, m, s);
      mw = pk_nanmax(mw, m);
      sw = sw + s;
    }
    if (lane == 0) {
      wm[w] = mw;
      ws[w] = sw;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      R m = wm[0];
      double s = ws[0];
      for (int k = 1; k < PK_HEALTH_WARPS; ++k) {
        m = pk_nanmax(m, wm[k]);
        s = s + ws[k];
      }
      const long long g = base + (c * X + x0 + lx) * (Y / ry) + y0 / ry + lu;
      pmax[g] = (double)m;
      psum[g] = s;
    }
    __syncthreads();
  }
}

// The fields of a finish launch: each one's units in the partials, its
// element count and its first slot in the health vector.
struct PkHealthFields {
  long long off[PK_HEALTH_MAX_FIELDS], rows[PK_HEALTH_MAX_FIELDS];
  double count[PK_HEALTH_MAX_FIELDS];
  int slot[PK_HEALTH_MAX_FIELDS];
};

// The finish: one block a field reduces its units' partials in the order of
// pk_reduce_partials_kernel (per thread, groups of 8 pairwise, folded in
// sequence; then a tree over the threads) and writes the field's three
// slots of the vector.
template <class O>
__global__ void __launch_bounds__(PK_REDUCE_THREADS)
pk_health_finish_kernel(const double* __restrict__ pmax,
                        const double* __restrict__ psum, PkHealthFields f,
                        O* __restrict__ out) {
  __shared__ double pm[PK_REDUCE_THREADS], ps[PK_REDUCE_THREADS];
  const int k = blockIdx.x;
  const long long n = f.rows[k];
  const double* am = pmax + f.off[k];
  const double* as = psum + f.off[k];
  double m = 0.0, s = 0.0;
  for (long long b = (long long)threadIdx.x * 8; b < n;
       b += (long long)PK_REDUCE_THREADS * 8) {
    double vm[8], vs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      vm[j] = b + j < n ? am[b + j] : 0.0;
      vs[j] = b + j < n ? as[b + j] : 0.0;
    }
    m = pk_nanmax(m, pk_nanmax(pk_nanmax(pk_nanmax(vm[0], vm[1]),
                                         pk_nanmax(vm[2], vm[3])),
                               pk_nanmax(pk_nanmax(vm[4], vm[5]),
                                         pk_nanmax(vm[6], vm[7]))));
    s = s + (((vs[0] + vs[1]) + (vs[2] + vs[3]))
             + ((vs[4] + vs[5]) + (vs[6] + vs[7])));
  }
  pm[threadIdx.x] = m;
  ps[threadIdx.x] = s;
  __syncthreads();
  for (int h = PK_REDUCE_THREADS / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) {
      pm[threadIdx.x] = pk_nanmax(pm[threadIdx.x], pm[threadIdx.x + h]);
      ps[threadIdx.x] = ps[threadIdx.x] + ps[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double mx = pm[0], mean = ps[0] / f.count[k];
    const bool finite = mx - mx == 0.0 && mean == mean;
    O* o = out + f.slot[k];
    o[0] = finite ? O(1) : O(0);
    o[1] = (O)mx;
    o[2] = (O)sqrt(mean);
  }
}

template <class T>
static int pk_health_launch(const void* x, void* pmax, void* psum,
                            long long nunits, int ry, int bx, int by, int Z,
                            int X, int Y, int x0, int y0, long long base,
                            int nsm, void* stream) {
  if (nunits <= 0) return 0;
  long long nb = nunits;
  const long long cap = (long long)(nsm > 0 ? nsm : 1) * 8;
  if (nb > cap) nb = cap;
  const bool vec = (uintptr_t)x % 16 == 0
                   && Z % PkHealthType<T>::V == 0;
  if (vec)
    pk_health_kernel<T, true><<<(unsigned)nb, PK_HEALTH_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const T*)x, (double*)pmax, (double*)psum, nunits, ry, bx, by, Z, X,
        Y, x0, y0, base);
  else
    pk_health_kernel<T, false><<<(unsigned)nb, PK_HEALTH_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const T*)x, (double*)pmax, (double*)psum, nunits, ry, bx, by, Z, X,
        Y, x0, y0, base);
  return (int)cudaGetLastError();
}

template <class O>
static int pk_health_finish_launch(const void* pmax, const void* psum,
                                   int nfields, const long long* off,
                                   const long long* rows,
                                   const double* count, const int* slot,
                                   void* out, void* stream) {
  if (nfields < 1 || nfields > PK_HEALTH_MAX_FIELDS) return -1;
  PkHealthFields f;
  for (int k = 0; k < nfields; ++k) {
    f.off[k] = off[k];
    f.rows[k] = rows[k];
    f.count[k] = count[k];
    f.slot[k] = slot[k];
  }
  pk_health_finish_kernel<O><<<(unsigned)nfields, PK_REDUCE_THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const double*)pmax, (const double*)psum, f, (O*)out);
  return (int)cudaGetLastError();
}

#define PK_HEALTH_ARGS                                                  \
  const void *x, void *pmax, void *psum, long long nunits, int ry, int bx, \
      int by, int Z, int X, int Y, int x0, int y0, long long base, int nsm, \
      void *stream
#define PK_HEALTH_PASS \
  x, pmax, psum, nunits, ry, bx, by, Z, X, Y, x0, y0, base, nsm, stream
#define PK_FINISH_ARGS                                                   \
  const void *pmax, const void *psum, int nfields, const long long *off, \
      const long long *rows, const double *count, const int *slot,       \
      void *out, void *stream
#define PK_FINISH_PASS pmax, psum, nfields, off, rows, count, slot, out, stream

extern "C" {

int pk_health_f32(PK_HEALTH_ARGS) {
  return pk_health_launch<float>(PK_HEALTH_PASS);
}

int pk_health_f64(PK_HEALTH_ARGS) {
  return pk_health_launch<double>(PK_HEALTH_PASS);
}

int pk_health_bf16(PK_HEALTH_ARGS) {
  return pk_health_launch<__nv_bfloat16>(PK_HEALTH_PASS);
}

int pk_health_finish_f32(PK_FINISH_ARGS) {
  return pk_health_finish_launch<float>(PK_FINISH_PASS);
}

int pk_health_finish_f64(PK_FINISH_ARGS) {
  return pk_health_finish_launch<double>(PK_FINISH_PASS);
}

// the fields one finish launch takes (the host splits no state: more
// fields raise there)
int pk_health_max_fields() { return PK_HEALTH_MAX_FIELDS; }

}  // extern "C"
