// Shared pieces of the fused Runge-Kutta stencil kernels (fused_stage.cu,
// fused_pair.cu): the math functions that ops/codegen.py prints, periodic
// index wrap, the tap loaders and the Laplacian in the accumulation order of
// the JAX package's lap_from_taps (pystella_tpu/ops/pallas_stencil.py).
//
// Every kernel is compiled against a generated header, pk_model.cuh, which
// defines PK_F (number of fields), PK_H (stencil radius) and
// pk_dvdf<T>(f, a, hubble, out), the model's dV/df_i at one site.
#pragma once

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

// The stage-updated field f1 = f + B * (A * kf + dt * dfdt) of the first
// stage of a pair, recomposed at (x, y, z) from the raw arrays instead of
// read from a materialized f1: the arithmetic of the JAX package's
// _axpy_taps (pystella_tpu/ops/fused.py).
template <typename T>
struct PkAxpyLoad {
  const T* __restrict__ f;
  const T* __restrict__ kf;
  const T* __restrict__ df;
  T B, A, dt;
  int Y, Z;
  __device__ __forceinline__ T operator()(int x, int y, int z) const {
    const int64_t i = ((int64_t)x * Y + y) * Z + z;
    return f[i] + B * (A * kf[i] + dt * df[i]);
  }
};

// lap = w0 * centre, then for s = 1..H: the x pair, the y pair, the z pair,
// each as acc + w * (tap(+s) + tap(-s)) -- lap_from_taps term by term.
template <typename T, typename Load>
__device__ __forceinline__ T pk_lap(const Load& load, T centre, int x, int y,
                                    int z, int X, int Y, int Z,
                                    const PkLapWeights<T>& w) {
  T acc = w.w0 * centre;
#pragma unroll
  for (int s = 1; s <= PK_H; ++s) {
    acc = acc + w.wx[s - 1] * (load(pk_wrap(x + s, X), y, z)
                               + load(pk_wrap(x - s, X), y, z));
    acc = acc + w.wy[s - 1] * (load(x, pk_wrap(y + s, Y), z)
                               + load(x, pk_wrap(y - s, Y), z));
    acc = acc + w.wz[s - 1] * (load(x, y, pk_wrap(z + s, Z))
                               + load(x, y, pk_wrap(z - s, Z)));
  }
  return acc;
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

// One thread per lattice site: z (the contiguous axis) is the fastest
// thread index, so a warp reads 32 neighbouring values of each array.
#define PK_BLOCK_Z 32
#define PK_BLOCK_Y 8

static inline dim3 pk_grid(int X, int Y, int Z) {
  return dim3((Z + PK_BLOCK_Z - 1) / PK_BLOCK_Z,
              (Y + PK_BLOCK_Y - 1) / PK_BLOCK_Y, X);
}
