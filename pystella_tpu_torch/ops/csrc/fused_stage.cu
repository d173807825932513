// K2: one fused 2N-storage Runge-Kutta stage of a ScalarSector system, and
// K5: the same stage emitting the energy sums of its entry state.
//
// K2 replaces the Pallas body FusedScalarStepper._scalar_body (+ _dV) of
// pystella_tpu/ops/fused.py, run by StreamingStencil / ResidentStencil
// (pystella_tpu/ops/pallas_stencil.py). Per site and field component:
//
//   lap   = order-2h Laplacian of f
//   rhs   = lap - 2*hubble*dfdt - a*a*dV/df
//   kf'   = A*kf + dt*dfdt        f'    = f + B*kf'
//   kdf'  = A*kdf + dt*rhs        dfdt' = dfdt + B*kdf'
//
// K5 (ENERGY = true) replaces _scalar_body(energy=True) + _esums, built by
// _ensure_energy_call, whose sums StreamingStencil._accumulate_sums carries
// across the TPU grid. It is K2 with the same arithmetic for the four lattice
// outputs (the template flag adds code after it, never inside it), plus, from
// values the site already holds, the terms dfdt*dfdt and (-f)*lap per
// component and V(f) -- summed over the lattice in a fixed order
// (pk_block_sums, pk_finish_sums in pk_common.cuh), in T.
//
// Bound: memory. Four arrays are read and four written per site (8 * F *
// sites * sizeof(T) bytes); the arithmetic is ~20 + 9h operations per
// component (K5 adds ~3 per component, V and the block tree). Design: one
// thread per site with z fastest, so every load and store is coalesced; the
// 6h neighbour taps of f are re-read through L1/L2 rather than staged in
// shared memory; periodic wrap by index arithmetic on all three axes, so any
// lattice shape runs (the JAX package needed a second, VMEM-resident kernel
// for small lattices). Offsets are 64-bit. Outputs go to separate buffers: a
// stencil cannot update its own input in place. The arithmetic order is the
// JAX body's, and the build uses -fmad=false, so no multiply-add is
// contracted where the plain PyTorch version rounds twice. K5 writes one
// partial per term and block (a few MB at 512^3) and reduces them in a
// second, small launch.
#include "pk_common.cuh"

template <typename T>
struct PkStageParams {
  T dt, a, hubble, A, B;
  PkLapWeights<T> w;
};

template <typename T, bool ENERGY>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
pk_fused_stage_kernel(const T* __restrict__ f, const T* __restrict__ dfdt,
                      const T* __restrict__ kf, const T* __restrict__ kdf,
                      T* __restrict__ f_out, T* __restrict__ dfdt_out,
                      T* __restrict__ kf_out, T* __restrict__ kdf_out,
                      int X, int Y, int Z, PkStageParams<T> p,
                      T* __restrict__ partials, int64_t nblocks) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  const bool active = z < Z && y < Y;
  // ENERGY: the block reduction needs every thread of the block
  if (!ENERGY && !active) return;
  T terms[PK_NT];
#pragma unroll
  for (int t = 0; t < PK_NT; ++t) terms[t] = T(0);

  if (active) {
    const int64_t N = (int64_t)X * Y * Z;
    const int64_t site = ((int64_t)x * Y + y) * Z + z;

    T fc[PK_F], lap[PK_F], dv[PK_F];
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      fc[c] = f[c * N + site];
      lap[c] = pk_lap(PkLoad<T>{f + c * N, Y, Z}, fc[c], x, y, z, X, Y, Z,
                      p.w);
    }
    pk_dvdf<T>(fc, p.a, p.hubble, dv);

    const T two_hub = T(2) * p.hubble;
    const T a2 = p.a * p.a;
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      const int64_t i = c * N + site;
      const T df0 = dfdt[i];
      const T rhs_df = (lap[c] - two_hub * df0) - a2 * dv[c];
      const T kf2 = p.A * kf[i] + p.dt * df0;
      const T kdf2 = p.A * kdf[i] + p.dt * rhs_df;
      f_out[i] = fc[c] + p.B * kf2;
      dfdt_out[i] = df0 + p.B * kdf2;
      kf_out[i] = kf2;
      kdf_out[i] = kdf2;
      if (ENERGY) {
        terms[c] = df0 * df0;
        terms[PK_F + c] = (-fc[c]) * lap[c];
      }
    }
    if (ENERGY) terms[2 * PK_F] = pk_v<T>(fc, p.a, p.hubble);
  }
  if (ENERGY) pk_block_sums<T, PK_NT>(terms, partials, nblocks);
}

// params: dt, a, hubble, A, B, then the Laplacian weights (pk_lap_weights).
// With ENERGY, partials holds PK_NT * pk_num_blocks(X, Y, Z) values and sums
// receives the PK_NT entry-state sums.
template <typename T, bool ENERGY>
static int pk_launch_stage(const void* f, const void* dfdt, const void* kf,
                           const void* kdf, void* f_out, void* dfdt_out,
                           void* kf_out, void* kdf_out, int X, int Y, int Z,
                           const double* params, void* partials, void* sums,
                           void* stream) {
  PkStageParams<T> p;
  p.dt = T(params[0]);
  p.a = T(params[1]);
  p.hubble = T(params[2]);
  p.A = T(params[3]);
  p.B = T(params[4]);
  p.w = pk_lap_weights<T>(params + 5);
  pk_fused_stage_kernel<T, ENERGY>
      <<<pk_grid(X, Y, Z), dim3(PK_BLOCK_Z, PK_BLOCK_Y, 1), 0,
         (cudaStream_t)stream>>>(
          (const T*)f, (const T*)dfdt, (const T*)kf, (const T*)kdf,
          (T*)f_out, (T*)dfdt_out, (T*)kf_out, (T*)kdf_out, X, Y, Z, p,
          (T*)partials, pk_num_blocks(X, Y, Z));
  const int rc = (int)cudaGetLastError();
  if (!ENERGY || rc != 0) return rc;
  return pk_finish_sums<T>(partials, sums, PK_NT, X, Y, Z,
                           (cudaStream_t)stream);
}

#define PK_STAGE_ARGS                                                       \
  const void *f, const void *dfdt, const void *kf, const void *kdf,         \
      void *fo, void *dfo, void *kfo, void *kdfo, int X, int Y, int Z,      \
      const double *params

extern "C" int pk_fused_stage_f32(PK_STAGE_ARGS, void* stream) {
  return pk_launch_stage<float, false>(f, dfdt, kf, kdf, fo, dfo, kfo, kdfo,
                                       X, Y, Z, params, nullptr, nullptr,
                                       stream);
}

extern "C" int pk_fused_stage_f64(PK_STAGE_ARGS, void* stream) {
  return pk_launch_stage<double, false>(f, dfdt, kf, kdf, fo, dfo, kfo, kdfo,
                                        X, Y, Z, params, nullptr, nullptr,
                                        stream);
}

extern "C" int pk_fused_stage_energy_f32(PK_STAGE_ARGS, void* partials,
                                         void* sums, void* stream) {
  return pk_launch_stage<float, true>(f, dfdt, kf, kdf, fo, dfo, kfo, kdfo,
                                      X, Y, Z, params, partials, sums, stream);
}

extern "C" int pk_fused_stage_energy_f64(PK_STAGE_ARGS, void* partials,
                                         void* sums, void* stream) {
  return pk_launch_stage<double, true>(f, dfdt, kf, kdf, fo, dfo, kfo, kdfo,
                                       X, Y, Z, params, partials, sums,
                                       stream);
}
