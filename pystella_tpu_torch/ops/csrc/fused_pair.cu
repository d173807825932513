// K3: two consecutive fused 2N-storage Runge-Kutta stages in one pass;
// K8: the same for the scalar + gravitational-wave system.
//
// K3 replaces the Pallas body FusedScalarStepper._pair_body /
// _scalar_pair_core (+ _axpy_taps, _dV) of pystella_tpu/ops/fused.py, run by
// StreamingStencil / ResidentStencil (pystella_tpu/ops/pallas_stencil.py).
// Stage 1 is K2's arithmetic on (f, dfdt, kf, kdfdt). Stage 2 needs the
// Laplacian of the stage-1 field f1 = f + B1*(A1*kf + dt*dfdt); f1 is never
// materialized in device memory: it is composed from the f, kf and dfdt
// taps with exactly that arithmetic (PkMarchInputs::composed, the JAX
// package's _axpy_taps), so the pair equals two K2 launches operation for
// operation, and a stage pair costs one pass over memory instead of two.
//
// With bfloat16 carries (C = __nv_bfloat16, the _bf16 entry points) kf and
// kdfdt (and khij, kdhijdt) are read widened to T -- at the site and, for
// kf (khij), wherever the f1 (h1) composition reads them -- and only the
// outputs kf2, kdf2 (kh2, kdh2) are rounded, after f2 and dfdt2 (h2, dh2)
// have been formed from them: stage 1's carries and the composed f1 and h1
// stay unrounded, as in the JAX package's pair body under _quantize_carries.
//
// K8 (GW = true) replaces the Pallas body FusedPreheatStepper._pair_body
// (pystella_tpu/ops/fused.py:1771), run by the streaming builder
// StreamingStencil._build (pystella_tpu/ops/pallas_stencil.py:709) and, on
// a sharded lattice, its halo-input variant _build_xhalo (:789): K3 on f,
// then per hij component two tensor stages (pk_gw_stage), stage 1 with lap h
// and S_ij1 from grad f, stage 2 with lap h1 and S_ij2 from grad f1 -- so
// K8 equals two K7 launches.
//
// Bound: memory. Four arrays are read and four written per site for two
// stages: 8 * F * sites * sizeof(T) bytes (K8 8 * (F + 6); 2.56 ms for K3,
// 10.3 for K8 at 512^3 f32 on an H100's 3.35 TB/s). One thread a site,
// every tap read through L1/L2 and f1 recomposed at each of its 6h taps,
// took about 13 taps of f and 40 of the arrays f1 is composed from per
// site (K8: about 500) against the 8 (64) element reads and writes the
// bound counts. So both run the x-march of pk_common.cuh (pk_march), the
// TPU builder's x ring carried to a block: a block walks a 32 x 8 (z, y)
// tile along x, holds a ring of 2h+1 planes and the haloed centre plane of
// every tapped array -- f and f1; for K8 also h and h1 -- in shared
// memory, and composes f1 (and h1) once an element as they are loaded, so
// device memory is read about once a launch (the y-z halo, 1.69x at h =
// 2, mostly from L2) and lap and grad read shared memory in
// lap_from_taps' order. K3 holds no tensor component (PkMarchTile<T, 0>):
// 4F planes' worth of tile, 27,392 bytes a block at the main path's F =
// 2, f32, h = 2, so registers rather than shared memory bound the blocks
// an SM (74-88 a thread in f32: two or three blocks, whatever minimum
// __launch_bounds__ asks for; it asks for one, as K8's does). A model
// whose arrays do not fit one block's shared memory marches once per group
// of fields (K8: of tensor components or, wider still, of fields first;
// pk_common.cuh's split layout). -fmad=false throughout; outputs to
// separate buffers; the tensor components one after another.
//
// The sharded tier (the _xpad, _ypad, _xypad entry points of K3 and K8)
// replaces StreamingStencil._build_xhalo (pystella_tpu/ops/pallas_stencil.py:
// 789) and, through the interior and shell launches,
// OverlapStreamingStencil (:931) on _pair_body, as _make_call
// (pystella_tpu/ops/fused.py:483) runs it on a sharded lattice. The windows
// -- f, dfdt and kf, and for K8 also hij, dhijdt and khij: the JAX pairs'
// windows (pystella_tpu/ops/fused.py:456, :1771) -- are padded along x
// and/or y by the neighbours' rows and read unwrapped there, at the site and
// at every tap of the Laplacians and gradients (PAD, PkGeom in
// pk_common.cuh; K8 loads a padded window's planes and rows where the march
// reaches them); kdfdt, kdhijdt and the outputs are the full block, the
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

// The x-march (pk_march, pk_common.cuh) of K3 and K8. Per plane and site,
// K3's arithmetic on f (pk_pair_scalar) -- lap f and lap f1 from the
// shared f and f1 planes --; for K8 then S_ij of both stages from grad f
// and grad f1, then per hij component the two tensor stages (pk_gw_stage),
// lap h and lap h1 from the shared h and h1 planes. The site's own dfdt,
// kf, kdfdt (and dhijdt, khij, kdhijdt; in the split layout also f) are
// read from device memory with the plane's loads (PkPairSite); in the
// joint layout f and hij come from the centre plane, which holds exactly
// what the window holds there. In the split layout a scalar pass evaluates
// dV/df of both stages from every field's site values, and runs the rest
// of the stage for its own fields.
template <typename T, int G>
struct PkPairSite {
  T f[PK_F], df[PK_F], kf[PK_F], kdf[PK_F];  // f, dfdt, kf, kdfdt (widened)
  T dh[G], kh[G], kdh[G];  // dhijdt, khij, kdhijdt of each hij held
};

template <typename T>
struct PkPairSite<T, 0> {
  T f[PK_F], df[PK_F], kf[PK_F], kdf[PK_F];
};

// A scalar pass's site values: window index wsite, block index site.
template <typename C, bool JOINT, typename T, typename S>
__device__ __forceinline__ void pk_pair_site(const PkArrays<T>& io,
                                             int64_t wsite, int64_t site,
                                             int64_t Nw, int64_t N, S& s) {
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    const int64_t wi = c * Nw + wsite;
    if (!JOINT) s.f[c] = io.in[0][wi];
    s.df[c] = io.in[1][wi];
    s.kf[c] = PkCarry<T, C>::load(pk_in_as<C>(io, 2)[wi]);
    s.kdf[c] = PkCarry<T, C>::load(pk_in_as<C>(io, 3)[c * N + site]);
  }
}

// K3's two stages at the thread's site (block index site; ctr its place in
// the centre plane) in scalar pass ps: stage 1 with the arithmetic of
// fused_stage.cu, stage 2 with lap f1 from the shared f1.
template <typename C, typename T, typename Pass, typename S>
__device__ __forceinline__ void pk_pair_scalar(const PkArrays<T>& io,
                                               int64_t site, int64_t N,
                                               const Pass ps,
                                               const PkMarchView<T>& v,
                                               const S& s,
                                               const PkPairParams<T>& p,
                                               int ctr) {
  using Tl = typename Pass::Tl;
  constexpr int F1 = Tl::GF;
  const T two_hub = T(2) * p.hubble2;
  // stage 1 on the site (the arithmetic of fused_stage.cu)
  T f0[PK_F], df1[PK_F], kf1[PK_F], kdf1[PK_F], f1[PK_F], dv[PK_F];
  T lap[PK_F];
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    f0[c] = Tl::JOINT ? v.sm[c * Tl::SITES + ctr] : s.f[c];
    if (ps.held(c)) lap[c] = pk_march_lap(v, c - ps.k0, f0[c], p.w);
    kf1[c] = p.A1 * s.kf[c] + p.dt * s.df[c];
    f1[c] = f0[c] + p.B1 * kf1[c];
  }
  pk_dvdf<T>(f0, p.a1, p.hubble1, dv);
  {
    const T two_hub1 = T(2) * p.hubble1;
    const T a2 = p.a1 * p.a1;
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      if (!ps.held(c)) continue;
      const T df0 = s.df[c];
      kdf1[c] = p.A1 * s.kdf[c]
                + p.dt * ((lap[c] - two_hub1 * df0) - a2 * dv[c]);
      df1[c] = df0 + p.B1 * kdf1[c];
    }
  }
  // the stage-2 Laplacian, from the shared f1
#pragma unroll
  for (int c = 0; c < PK_F; ++c)
    if (ps.held(c)) lap[c] = pk_march_lap(v, F1 + c - ps.k0, f1[c], p.w);
  // stage 2 on the site
  pk_dvdf<T>(f1, p.a2, p.hubble2, dv);
  const T a2 = p.a2 * p.a2;
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    if (!ps.held(c)) continue;
    const int64_t i = c * N + site;
    const T kf2 = p.A2 * kf1[c] + p.dt * df1[c];
    const T kdf2 = p.A2 * kdf1[c]
                   + p.dt * ((lap[c] - two_hub * df1[c]) - a2 * dv[c]);
    io.out[0][i] = f1[c] + p.B2 * kf2;
    io.out[1][i] = df1[c] + p.B2 * kdf2;
    pk_out_as<C>(io, 2)[i] = PkCarry<T, C>::store(kf2);
    pk_out_as<C>(io, 3)[i] = PkCarry<T, C>::store(kdf2);
  }
}

// K3: the scalar march (no tensor components).
template <typename T, typename C, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y, 1)
pk_fused_pair_kernel(PkArrays<T> io, int X, int Y, int Z,
                     PkPairParams<T> p, PkGeom g) {
  using Tl = PkMarchTile<T, 0>;
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t Nw = PAD ? g.Nw : N;
  const int Yw = PAD ? g.Ys : Y;
  const PkMarchInputs<T, C, false> in{
      {io.in[0], nullptr}, {io.in[1], nullptr},
      {pk_in_as<C>(io, 2), nullptr}, {nullptr, nullptr},
      p.B1, p.A1, p.dt, T(0), T(0)};
  const int z = blockIdx.x * Tl::TZ + threadIdx.x;
  const int y = blockIdx.y * Tl::TY + threadIdx.y;
  const bool valid = z < Z && y < Y;
  const int ctr = (threadIdx.y + PK_H) * Tl::SZ + threadIdx.x + PK_H;
  auto pre = [&](int x, const PkMarchPass<T, 0>) {
    PkPairSite<T, 0> s{};
    if (!valid) return s;
    const int64_t site = ((int64_t)x * Y + y) * Z + z;
    const int64_t wsite = PAD ? ((int64_t)x * Yw + y) * Z + z : site;
    pk_pair_site<C, Tl::JOINT>(io, wsite, site, Nw, N, s);
    return s;
  };
  pk_march<T, 0, PAD>(in, X, Y, Z, Nw, Yw, pre, [&](
      int x, int, const PkMarchPass<T, 0> ps, const PkMarchView<T>& v,
      const PkPairSite<T, 0>& s) {
    if (valid)
      pk_pair_scalar<C>(io, ((int64_t)x * Y + y) * Z + z, N, ps, v, s, p,
                        ctr);
  });
}

#ifdef PK_NH
// K8: the march with the tensor components.
template <typename T, typename C, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y, 1)
pk_preheat_pair_kernel(PkArrays<T> io, int X, int Y, int Z,
                       PkPairParams<T> p, PkGeom g) {
  using Tl = PkMarchTile<T, PK_NH>;
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t Nw = PAD ? g.Nw : N;
  const int Yw = PAD ? g.Ys : Y;
  const PkMarchInputs<T, C, false> in{
      {io.in[0], io.in[4]}, {io.in[1], io.in[5]},
      {pk_in_as<C>(io, 2), pk_in_as<C>(io, 6)}, {nullptr, nullptr},
      p.B1, p.A1, p.dt, T(0), T(0)};
  const int z = blockIdx.x * Tl::TZ + threadIdx.x;
  const int y = blockIdx.y * Tl::TY + threadIdx.y;
  const bool valid = z < Z && y < Y;
  // the shared arrays: f, f1 of each field a pass holds, then h, h1 of
  // each component it holds
  constexpr int F1 = Tl::GF, H0 = Tl::HS, H1 = Tl::HS + Tl::G;
  const int ctr = (threadIdx.y + PK_H) * Tl::SZ + threadIdx.x + PK_H;
  // split layout: grad f and grad f1 of every field at each plane of the
  // run, parked by the scalar passes for the tensor passes' S_ij
  T grads[Tl::JOINT ? 1 : Tl::LX][2][PK_F][3];
  auto pre = [&](int x, const PkMarchPass<T, PK_NH> ps) {
    PkPairSite<T, Tl::G> s{};
    if (!valid) return s;
    const int64_t site = ((int64_t)x * Y + y) * Z + z;
    const int64_t wsite = PAD ? ((int64_t)x * Yw + y) * Z + z : site;
    if (ps.scalar) pk_pair_site<C, Tl::JOINT>(io, wsite, site, Nw, N, s);
    if (ps.tensors()) {
#pragma unroll
      for (int j = 0; j < Tl::G; ++j) {
        const int c = ps.c0 + j;
        const int64_t wi = c * Nw + wsite;
        s.dh[j] = io.in[5][wi];
        s.kh[j] = PkCarry<T, C>::load(pk_in_as<C>(io, 6)[wi]);
        s.kdh[j] = PkCarry<T, C>::load(pk_in_as<C>(io, 7)[c * N + site]);
      }
    }
    return s;
  };
  pk_march<T, PK_NH, PAD>(in, X, Y, Z, Nw, Yw, pre, [&](
      int x, int px, const PkMarchPass<T, PK_NH> ps,
      const PkMarchView<T>& v, const PkPairSite<T, Tl::G>& s) {
    if (!valid) return;
    const int64_t site = ((int64_t)x * Y + y) * Z + z;
    const T two_hub = T(2) * p.hubble2;
    if (ps.scalar) pk_pair_scalar<C>(io, site, N, ps, v, s, p, ctr);

    // S_ij of both stages: from grad f and grad f1
    T sij1[PK_NH], sij2[PK_NH];
    if constexpr (Tl::JOINT) {
      T dfdx[PK_F][3];
#pragma unroll
      for (int c = 0; c < PK_F; ++c) pk_march_grad(v, c, p.g, dfdx[c]);
      pk_sij<T>(dfdx, p.a1, p.hubble1, sij1);
#pragma unroll
      for (int c = 0; c < PK_F; ++c) pk_march_grad(v, F1 + c, p.g, dfdx[c]);
      pk_sij<T>(dfdx, p.a2, p.hubble2, sij2);
    } else if (ps.scalar) {
#pragma unroll
      for (int c = 0; c < PK_F; ++c) {
        if (!ps.held(c)) continue;
        pk_march_grad(v, c - ps.k0, p.g, grads[px][0][c]);
        pk_march_grad(v, F1 + c - ps.k0, p.g, grads[px][1][c]);
      }
    } else {
      pk_sij<T>(grads[px][0], p.a1, p.hubble1, sij1);
      pk_sij<T>(grads[px][1], p.a2, p.hubble2, sij2);
    }

    if (!ps.tensors()) return;
    const T two_hub1 = T(2) * p.hubble1;
#pragma unroll
    for (int j = 0; j < Tl::G; ++j) {
      const int c = ps.c0 + j;
      const int64_t i = c * N + site;
      const T h0 = v.sm[(H0 + j) * Tl::SITES + ctr];
      const T lap_h = pk_march_lap(v, H0 + j, h0, p.w);
      T h1, dh1, kh1, kdh1;
      pk_gw_stage(h0, s.dh[j], s.kh[j], s.kdh[j], lap_h, sij1[c], p.A1,
                  p.B1, p.dt, two_hub1, h1, dh1, kh1, kdh1);
      const T lap_h1 = pk_march_lap(v, H1 + j, h1, p.w);
      T h2, dh2, kh2, kdh2;
      pk_gw_stage(h1, dh1, kh1, kdh1, lap_h1, sij2[c], p.A2, p.B2, p.dt,
                  two_hub, h2, dh2, kh2, kdh2);
      io.out[4][i] = h2;
      io.out[5][i] = dh2;
      pk_out_as<C>(io, 6)[i] = PkCarry<T, C>::store(kh2);
      pk_out_as<C>(io, 7)[i] = PkCarry<T, C>::store(kdh2);
    }
  });
}
#endif

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
#ifdef PK_NH
  if constexpr (GW) {
    p.g = pk_grad_weights<T>(params + 9 + PK_NLAPW);
    return pk_march_launch<T, PK_NH>(pk_preheat_pair_kernel<T, C, PAD>, X,
                                     Y, Z, stream,
                                     pk_arrays<T>(ins, outs, 8), X, Y, Z,
                                     p, g);
  } else
#endif
  return pk_march_launch<T, 0>(pk_fused_pair_kernel<T, C, PAD>, X, Y, Z,
                               stream, pk_arrays<T>(ins, outs, 4), X, Y, Z,
                               p, g);
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

PK_SCALAR_MARCH_ENTRY
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
