// K3: two consecutive fused 2N-storage Runge-Kutta stages in one pass;
// K8: the same for the scalar + gravitational-wave system.
//
// K3 replaces the Pallas body FusedScalarStepper._pair_body /
// _scalar_pair_core (+ _axpy_taps, _dV) of pystella_tpu/ops/fused.py, run by
// StreamingStencil / ResidentStencil (pystella_tpu/ops/pallas_stencil.py).
// Stage 1 is K2's arithmetic on (f, dfdt, kf, kdfdt). Stage 2 needs the
// Laplacian of the stage-1 field f1 = f + B1*(A1*kf + dt*dfdt); f1 is never
// materialized: at each of its 6h taps it is recomposed from the f, kf and
// dfdt taps with exactly that arithmetic (PkAxpyLoad), so the pair equals
// two K2 launches operation for operation, and a stage pair costs one pass
// over memory instead of two.
//
// With bfloat16 carries (C = __nv_bfloat16, the _bf16 entry points) kf and
// kdfdt (and khij, kdhijdt) are read widened to T -- at the site and, for
// kf (khij), at every tap the f1 (h1) recomposition reads -- and only the
// outputs kf2, kdf2 (kh2, kdh2) are rounded, after f2 and dfdt2 (h2, dh2)
// have been formed from them: stage 1's carries and the recomposed f1 and h1
// stay unrounded, as in the JAX package's pair body under _quantize_carries.
//
// K8 (GW = true) replaces FusedPreheatStepper._pair_body: K3 on f, then per
// hij component two tensor stages (pk_gw_stage), stage 1 with lap h from the
// hij window and S_ij1 from the gradients of the f window, stage 2 with
// lap h1 recomposed from the hij, khij and dhijdt taps and S_ij2 from the
// gradients of the recomposed f1 -- so K8 equals two K7 launches.
//
// Bound: memory. Four arrays are read and four written per site (8 * F *
// sites * sizeof(T) bytes for two stages; K8 8 * (F + 6)); f, kf and dfdt
// (and hij, khij, dhijdt) are also read at the 6h neighbour taps, through
// L1/L2. Design as in fused_stage.cu: one thread per site, z fastest,
// periodic wrap by index arithmetic, 64-bit offsets, outputs to separate
// buffers, -fmad=false, the tensor components one after another.
//
// The sharded tier (the _xpad, _ypad, _xypad entry points of K3 and K8)
// replaces StreamingStencil._build_xhalo (pystella_tpu/ops/pallas_stencil.py:
// 789) and, through the interior and shell launches,
// OverlapStreamingStencil (:931) on _pair_body, as _make_call
// (pystella_tpu/ops/fused.py:483) runs it on a sharded lattice. The windows
// -- f, dfdt and kf, and for K8 also hij, dhijdt and khij: the JAX pairs'
// windows (pystella_tpu/ops/fused.py:456, :1771) -- are padded along x
// and/or y by the neighbours' rows and read unwrapped there, at the site and
// by PkAxpyLoad at every tap of the Laplacians and gradients (PAD, PkGeom in
// pk_common.cuh); kdfdt, kdhijdt and the outputs are the full block, the
// region's rows from its first x row. The arithmetic is the unpadded
// kernel's, so a padded launch equals it on the whole lattice bit for bit,
// and an interior plus two shell launches equal a padded launch. With
// bfloat16 carries (_bf16_xpad, ...) the kf (khij) window is padded in
// bfloat16 and read as C with the window's geometry, counted in elements of
// C; the padded _bf16 launch equals the unpadded _bf16 kernel bit for bit.
#include "pk_common.cuh"

template <typename T>
struct PkPairParams {
  T dt, a1, hubble1, A1, B1, a2, hubble2, A2, B2;
  PkLapWeights<T> w;
  PkGradWeights<T> g;  // K8 only
};

template <typename T, typename C, bool GW, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
pk_fused_pair_kernel(PkArrays<T> io, int X, int Y, int Z,
                     PkPairParams<T> p, PkGeom g) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= Z || y >= Y) return;
  // the blockwise arrays (kdfdt, the outputs) and the windows (f, dfdt, kf),
  // each with its own geometry
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const int64_t Nw = PAD ? g.Nw : N;
  const int Yw = PAD ? g.Ys : Y;
  const int64_t wsite = PAD ? ((int64_t)x * Yw + y) * Z + z : site;
  const T* __restrict__ f = io.in[0];
  const T* __restrict__ dfdt = io.in[1];
  const C* __restrict__ kf = pk_in_as<C>(io, 2);
  const C* __restrict__ kdf = pk_in_as<C>(io, 3);
  T* __restrict__ f_out = io.out[0];
  T* __restrict__ dfdt_out = io.out[1];
  C* __restrict__ kf_out = pk_out_as<C>(io, 2);
  C* __restrict__ kdf_out = pk_out_as<C>(io, 3);

  // stage 1 on the site (the arithmetic of fused_stage.cu)
  T f0[PK_F], df1[PK_F], kf1[PK_F], kdf1[PK_F], f1[PK_F], dv[PK_F];
  T lap[PK_F];
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    const int64_t wi = c * Nw + wsite;
    f0[c] = f[wi];
    lap[c] = pk_lap<PAD>(PkLoad<T>{f + c * Nw, Yw, Z}, f0[c], x, y, z, X, Y,
                         Z, p.w);
    kf1[c] = p.A1 * PkCarry<T, C>::load(kf[wi]) + p.dt * dfdt[wi];
    f1[c] = f0[c] + p.B1 * kf1[c];
  }
  pk_dvdf<T>(f0, p.a1, p.hubble1, dv);
  {
    const T two_hub = T(2) * p.hubble1;
    const T a2 = p.a1 * p.a1;
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      const int64_t i = c * N + site;
      const T df0 = dfdt[c * Nw + wsite];
      kdf1[c] = p.A1 * PkCarry<T, C>::load(kdf[i])
                + p.dt * ((lap[c] - two_hub * df0) - a2 * dv[c]);
      df1[c] = df0 + p.B1 * kdf1[c];
    }
  }

  // the stage-2 Laplacian, from f1 recomposed at every tap
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    const PkAxpyLoad<T, PkAt<T>, C> load{f + c * Nw, kf + c * Nw,
                                         {dfdt + c * Nw}, p.B1, p.A1, p.dt,
                                         Yw, Z};
    lap[c] = pk_lap<PAD>(load, f1[c], x, y, z, X, Y, Z, p.w);
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
    kf_out[i] = PkCarry<T, C>::store(kf2);
    kdf_out[i] = PkCarry<T, C>::store(kdf2);
  }

#ifdef PK_NH
  if constexpr (GW) {
    // S_ij of both stages: from the f window, and from f1 recomposed at
    // every tap
    T dfdx[PK_F][3], sij1[PK_NH], sij2[PK_NH];
#pragma unroll
    for (int c = 0; c < PK_F; ++c)
      pk_grad<PAD>(PkLoad<T>{f + c * Nw, Yw, Z}, x, y, z, X, Y, Z, p.g,
                   dfdx[c]);
    pk_sij<T>(dfdx, p.a1, p.hubble1, sij1);
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      const PkAxpyLoad<T, PkAt<T>, C> load{f + c * Nw, kf + c * Nw,
                                           {dfdt + c * Nw}, p.B1, p.A1,
                                           p.dt, Yw, Z};
      pk_grad<PAD>(load, x, y, z, X, Y, Z, p.g, dfdx[c]);
    }
    pk_sij<T>(dfdx, p.a2, p.hubble2, sij2);

    const T* __restrict__ h = io.in[4];
    const T* __restrict__ dh = io.in[5];
    const C* __restrict__ kh = pk_in_as<C>(io, 6);
    const C* __restrict__ kdh = pk_in_as<C>(io, 7);
    C* __restrict__ kh_out = pk_out_as<C>(io, 6);
    C* __restrict__ kdh_out = pk_out_as<C>(io, 7);
    const T two_hub1 = T(2) * p.hubble1;
#pragma unroll 1
    for (int c = 0; c < PK_NH; ++c) {
      const int64_t i = c * N + site;
      const int64_t wi = c * Nw + wsite;
      const T h0 = h[wi];
      const T lap_h = pk_lap<PAD>(PkLoad<T>{h + c * Nw, Yw, Z}, h0, x, y, z,
                                  X, Y, Z, p.w);
      T h1, dh1, kh1, kdh1;
      pk_gw_stage(h0, dh[wi], PkCarry<T, C>::load(kh[wi]),
                  PkCarry<T, C>::load(kdh[i]), lap_h, sij1[c], p.A1, p.B1,
                  p.dt, two_hub1, h1, dh1, kh1, kdh1);
      const PkAxpyLoad<T, PkAt<T>, C> load{h + c * Nw, kh + c * Nw,
                                           {dh + c * Nw}, p.B1, p.A1, p.dt,
                                           Yw, Z};
      const T lap_h1 = pk_lap<PAD>(load, h1, x, y, z, X, Y, Z, p.w);
      T h2, dh2, kh2, kdh2;
      pk_gw_stage(h1, dh1, kh1, kdh1, lap_h1, sij2[c], p.A2, p.B2, p.dt,
                  two_hub, h2, dh2, kh2, kdh2);
      io.out[4][i] = h2;
      io.out[5][i] = dh2;
      kh_out[i] = PkCarry<T, C>::store(kh2);
      kdh_out[i] = PkCarry<T, C>::store(kdh2);
    }
  }
#endif
}

// ins / outs: host arrays of 4 (scalar) or 8 (GW: then hij, dhijdt, khij,
// kdhijdt) device pointers. params: dt, a1, hubble1, A1, B1, a2, hubble2,
// A2, B2, then the Laplacian weights (pk_lap_weights) and, for GW, the
// gradient weights (pk_grad_weights).
template <typename T, typename C, bool GW, int PAD = 0>
static int pk_launch_pair(const void* const* ins, void* const* outs, int X,
                          int Y, int Z, const double* params, void* stream,
                          PkGeom g = PkGeom{0, 0, 0, 0, 0, 0}) {
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
  if (GW) p.g = pk_grad_weights<T>(params + 9 + PK_NLAPW);
  pk_fused_pair_kernel<T, C, GW, PAD>
      <<<pk_grid(X, Y, Z), dim3(PK_BLOCK_Z, PK_BLOCK_Y, 1), 0,
         (cudaStream_t)stream>>>(pk_arrays<T>(ins, outs, GW ? 8 : 4), X,
                                 Y, Z, p, g);
  return (int)cudaGetLastError();
}

#define PK_PAIR_ARGS                                                        \
  const void *const *ins, void *const *outs, int X, int Y, int Z,           \
      const double *params, void *stream

// One entry point per (T, C, GW) instantiation; the _bf16 ones store the
// carries in bfloat16.
#define PK_PAIR_ENTRY(name, T, C, GW)                                       \
  extern "C" int name(PK_PAIR_ARGS) {                                       \
    return pk_launch_pair<T, C, GW>(ins, outs, X, Y, Z, params, stream);    \
  }

// The sharded tier: a pair on windows padded along x, y or both (interior
// and shell launches take the x-padded entry point). The arguments of every
// padded entry point of the fused sources (fused_stage.cu): partials and
// nblocks (no sums here: null and 0), then Nb, Nw, Ys (PkGeom; x0, yb0, GYb
// unused).
#define PK_PAIR_PAD_ENTRY(name, T, C, GW, PAD)                              \
  extern "C" int name(const void* const* ins, void* const* outs, int X,     \
                      int Y, int Z, const double* params, void* partials,   \
                      int64_t nblocks, int64_t Nb, int64_t Nw, int Ys,      \
                      int x0, int yb0, int GYb, void* stream) {             \
    return pk_launch_pair<T, C, GW, PAD>(ins, outs, X, Y, Z, params,        \
                                         stream,                            \
                                         PkGeom{Nb, Nw, Ys, x0, yb0, GYb}); \
  }
// the three paddings of one (T, C) instantiation
#define PK_PAIR_PADS(name, T, C, GW)                                        \
  PK_PAIR_PAD_ENTRY(name##_xpad, T, C, GW, PK_PAD_X)                        \
  PK_PAIR_PAD_ENTRY(name##_ypad, T, C, GW, PK_PAD_Y)                        \
  PK_PAIR_PAD_ENTRY(name##_xypad, T, C, GW, PK_PAD_X | PK_PAD_Y)
// f32 and f64, the carries in T and in bfloat16 (_bf16)
#define PK_PAIR_PAD_ENTRIES(name, GW)                                       \
  PK_PAIR_PADS(name##_f32, float, float, GW)                                \
  PK_PAIR_PADS(name##_f64, double, double, GW)                              \
  PK_PAIR_PADS(name##_f32_bf16, float, __nv_bfloat16, GW)                   \
  PK_PAIR_PADS(name##_f64_bf16, double, __nv_bfloat16, GW)

PK_PAIR_PAD_ENTRIES(pk_fused_pair, false)
PK_PAIR_ENTRY(pk_fused_pair_f32, float, float, false)
PK_PAIR_ENTRY(pk_fused_pair_f64, double, double, false)
PK_PAIR_ENTRY(pk_fused_pair_f32_bf16, float, __nv_bfloat16, false)
PK_PAIR_ENTRY(pk_fused_pair_f64_bf16, double, __nv_bfloat16, false)

#ifdef PK_NH
PK_PAIR_ENTRY(pk_preheat_pair_f32, float, float, true)
PK_PAIR_ENTRY(pk_preheat_pair_f64, double, double, true)
PK_PAIR_ENTRY(pk_preheat_pair_f32_bf16, float, __nv_bfloat16, true)
PK_PAIR_ENTRY(pk_preheat_pair_f64_bf16, double, __nv_bfloat16, true)
PK_PAIR_PAD_ENTRIES(pk_preheat_pair, true)
#endif
