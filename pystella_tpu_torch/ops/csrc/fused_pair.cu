// K3: two consecutive fused 2N-storage Runge-Kutta stages in one pass.
//
// Replaces the Pallas body FusedScalarStepper._pair_body /
// _scalar_pair_core (+ _axpy_taps, _dV) of pystella_tpu/ops/fused.py, run by
// StreamingStencil / ResidentStencil (pystella_tpu/ops/pallas_stencil.py).
// Stage 1 is K2's arithmetic on (f, dfdt, kf, kdfdt). Stage 2 needs the
// Laplacian of the stage-1 field f1 = f + B1*(A1*kf + dt*dfdt); f1 is never
// materialized: at each of its 6h taps it is recomposed from the f, kf and
// dfdt taps with exactly that arithmetic (PkAxpyLoad), so the pair equals
// two K2 launches operation for operation, and a stage pair costs one pass
// over memory instead of two.
//
// Bound: memory. Four arrays are read and four written per site (8 * F *
// sites * sizeof(T) bytes for two stages); f, kf and dfdt are also read at
// the 6h neighbour taps, through L1/L2. Design as in fused_stage.cu: one
// thread per site, z fastest, periodic wrap by index arithmetic, 64-bit
// offsets, outputs to separate buffers, -fmad=false.
#include "pk_common.cuh"

template <typename T>
struct PkPairParams {
  T dt, a1, hubble1, A1, B1, a2, hubble2, A2, B2;
  PkLapWeights<T> w;
};

template <typename T>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
pk_fused_pair_kernel(const T* __restrict__ f, const T* __restrict__ dfdt,
                     const T* __restrict__ kf, const T* __restrict__ kdf,
                     T* __restrict__ f_out, T* __restrict__ dfdt_out,
                     T* __restrict__ kf_out, T* __restrict__ kdf_out,
                     int X, int Y, int Z, PkPairParams<T> p) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= Z || y >= Y) return;
  const int64_t N = (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;

  // stage 1 on the site (the arithmetic of fused_stage.cu)
  T f0[PK_F], df1[PK_F], kf1[PK_F], kdf1[PK_F], f1[PK_F], dv[PK_F];
  T lap[PK_F];
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    const int64_t i = c * N + site;
    f0[c] = f[i];
    lap[c] = pk_lap(PkLoad<T>{f + c * N, Y, Z}, f0[c], x, y, z, X, Y, Z, p.w);
    kf1[c] = p.A1 * kf[i] + p.dt * dfdt[i];
    f1[c] = f0[c] + p.B1 * kf1[c];
  }
  pk_dvdf<T>(f0, p.a1, p.hubble1, dv);
  {
    const T two_hub = T(2) * p.hubble1;
    const T a2 = p.a1 * p.a1;
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      const int64_t i = c * N + site;
      const T df0 = dfdt[i];
      kdf1[c] = p.A1 * kdf[i] + p.dt * ((lap[c] - two_hub * df0) - a2 * dv[c]);
      df1[c] = df0 + p.B1 * kdf1[c];
    }
  }

  // the stage-2 Laplacian, from f1 recomposed at every tap
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    const PkAxpyLoad<T> load{f + c * N, kf + c * N, {dfdt + c * N},
                             p.B1, p.A1, p.dt, Y, Z};
    lap[c] = pk_lap(load, f1[c], x, y, z, X, Y, Z, p.w);
  }

  // stage 2 on the site
  pk_dvdf<T>(f1, p.a2, p.hubble2, dv);
  const T two_hub = T(2) * p.hubble2;
  const T a2 = p.a2 * p.a2;
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    const int64_t i = c * N + site;
    const T kf2 = p.A2 * kf1[c] + p.dt * df1[c];
    const T kdf2 = p.A2 * kdf1[c]
                   + p.dt * ((lap[c] - two_hub * df1[c]) - a2 * dv[c]);
    f_out[i] = f1[c] + p.B2 * kf2;
    dfdt_out[i] = df1[c] + p.B2 * kdf2;
    kf_out[i] = kf2;
    kdf_out[i] = kdf2;
  }
}

// params: dt, a1, hubble1, A1, B1, a2, hubble2, A2, B2, then the Laplacian
// weights (pk_lap_weights).
template <typename T>
static int pk_launch_pair(const void* f, const void* dfdt, const void* kf,
                          const void* kdf, void* f_out, void* dfdt_out,
                          void* kf_out, void* kdf_out, int X, int Y, int Z,
                          const double* params, void* stream) {
  PkPairParams<T> p;
  p.dt = T(params[0]);
  p.a1 = T(params[1]);
  p.hubble1 = T(params[2]);
  p.A1 = T(params[3]);
  p.B1 = T(params[4]);
  p.a2 = T(params[5]);
  p.hubble2 = T(params[6]);
  p.A2 = T(params[7]);
  p.B2 = T(params[8]);
  p.w = pk_lap_weights<T>(params + 9);
  pk_fused_pair_kernel<T>
      <<<pk_grid(X, Y, Z), dim3(PK_BLOCK_Z, PK_BLOCK_Y, 1), 0,
         (cudaStream_t)stream>>>(
          (const T*)f, (const T*)dfdt, (const T*)kf, (const T*)kdf,
          (T*)f_out, (T*)dfdt_out, (T*)kf_out, (T*)kdf_out, X, Y, Z, p);
  return (int)cudaGetLastError();
}

extern "C" int pk_fused_pair_f32(const void* f, const void* dfdt,
                                 const void* kf, const void* kdf, void* fo,
                                 void* dfo, void* kfo, void* kdfo, int X,
                                 int Y, int Z, const double* params,
                                 void* stream) {
  return pk_launch_pair<float>(f, dfdt, kf, kdf, fo, dfo, kfo, kdfo, X, Y, Z,
                               params, stream);
}

extern "C" int pk_fused_pair_f64(const void* f, const void* dfdt,
                                 const void* kf, const void* kdf, void* fo,
                                 void* dfo, void* kfo, void* kdfo, int X,
                                 int Y, int Z, const double* params,
                                 void* stream) {
  return pk_launch_pair<double>(f, dfdt, kf, kdf, fo, dfo, kfo, kdfo, X, Y, Z,
                                params, stream);
}
