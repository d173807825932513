// K2: one fused 2N-storage Runge-Kutta stage of a ScalarSector system;
// K5: the same stage emitting the energy sums of its entry state;
// K7 and K5': both for the scalar + gravitational-wave system.
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
// K5 (ENERGY) replaces _scalar_body(energy=True) + _esums, built by
// _ensure_energy_call, whose sums StreamingStencil._accumulate_sums carries
// across the TPU grid. It is K2 with the same arithmetic for the lattice
// outputs, plus, from values the site already holds, the terms dfdt*dfdt
// and (-f)*lap per component and V(f) -- summed over the lattice in a fixed
// order (pk_march_sums, pk_finish_sums in pk_common.cuh), in T.
//
// K7 (GW) replaces FusedPreheatStepper._preheat_body (+ _gw_stage,
// _sij_eval): K2 on f, then per hij component the tensor stage
// (pk_gw_stage) with lap h from the hij window and the source S_ij printed
// from the gradients of the same f window (pk_grad, grad_from_taps order).
// K5' (GW and ENERGY) replaces FusedPreheatStepper._ensure_energy_call: K7
// plus the scalar sector's sums only (the expansion couples to the f
// energy), so its lattice outputs are K7's bit for bit, and its scalar
// outputs and sums K5's.
//
// With bfloat16 carries (C = __nv_bfloat16, the _bf16 entry points, for
// carry_dtype=bfloat16) every variant reads its carries (kf, kdfdt, and
// khij, kdhijdt) widened to T and writes them rounded to nearest even
// (PkCarry), after f and dfdt (hij, dhijdt) have been formed from the
// unrounded values: the order of the JAX package's _quantize_carries
// (pystella_tpu/ops/fused.py:76). K5 and K5' take their energy sums from the
// widened working-type values, as the JAX body takes them before the cast.
// K2 moves 2F of its 8F component-arrays at 2 bytes a value, K7 8 of 16.
//
// The velocity carries come in a type of their own, KD: C, except in the
// _bf16_fin energy stages, where they are T. Those run the coupled driver's
// odd trailing stage, after the finalize that completed the last pair's
// deferred Hubble drag: the JAX package's finalize leaves kdfdt (kdhijdt)
// unrounded, in the working type, and its energy stage reads it so.
//
// Bound: memory. Four arrays are read and four written per site (8 * F *
// sites * sizeof(T) bytes; the GW variants 8 * (F + 6)); the arithmetic is
// ~20 + 9h operations per component (K5 adds ~3 per component, V and the
// tile's sum tree; K7 adds the 6h-tap gradients and S_ij). Offsets are
// 64-bit. Outputs go to separate buffers: a stencil cannot update its own
// input in place. The arithmetic order is the JAX body's, and the build
// uses -fmad=false, so no multiply-add is contracted where the plain
// PyTorch version rounds twice.
//
// Every variant marches, one template (pk_stage_march_kernel over
// pk_march, pk_common.cuh, with V = 1; K2 is K5 without the sums): the TPU
// builder's x ring (StreamingStencil._build, pystella_tpu/ops/
// pallas_stencil.py:709, the ring :719-742) carried to a block, as the
// pairs K8 and K9 carry it. A block walks a 32 x 8 (z, y) tile along x in
// runs of PK_STAGE_MARCH_LX planes (K2 and K5: PK_SCALAR_STAGE_MARCH_LX)
// and holds, per tapped array -- f of each field, h of each tensor
// component (none for K2 and K5) -- a ring of 2h+1 planes of the tile and
// the centre plane with its y-z halo in shared memory (joint: F + 6
// arrays, 54,784 bytes at f32, h = 2, F = 2; K2 and K5 F arrays, 13,696
// bytes). Lap f, grad f and lap h run pk_lap / pk_grad over those planes in
// box coordinates (PK_BOX), so their order is lap_from_taps' and
// grad_from_taps', and each tapped element is read from device memory
// about once. The energy variants reduce each plane's sum terms per 32 x 8
// tile in a fixed tree and write them where the per-site block of that
// plane wrote them (pk_march_sums; PkGeom's x0, yb0, GYb on a padded
// launch), before the tensor stage, so the terms do not stay live through
// it; the partials and the second launch are the per-site ones, and so are
// the sums, bit for bit. K2 and K5 do little between their barriers, so
// they load the next plane's ring and frame a step ahead
// (PK_SCALAR_STAGE_AHEAD), as fd_ops.cu's march does; K2 with bfloat16
// carries does not. A model whose f and h arrays do not fit one block
// marches once per group of components or, wider still, in the split layout
// (scalar passes that park grad f for the tensor passes), as the pairs do;
// ops/fused.py:march_tile(values=1) mirrors the tile. A shell launch's
// region of h planes is a run cut short.
//
// PK_STAGE_PER_SITE 1 runs K2 per site instead (pk_fused_stage_kernel):
// the yardstick the smoke times K2's march against and the card tests hold
// every stage march to (K5, K7 and K5' through K2's outputs). One thread
// per site with z fastest, so every load and store is coalesced; the 6h
// neighbour taps of f are re-read through L1/L2; periodic wrap by index
// arithmetic on all three axes.
//
// The sharded tier (the _xpad, _ypad, _xypad entry points of every variant)
// replaces StreamingStencil._build_xhalo (pystella_tpu/ops/pallas_stencil.py:
// 789) and, through the interior and shell launches of K2 and K7,
// OverlapStreamingStencil (:931) on _scalar_body and _preheat_body, as
// _make_call (pystella_tpu/ops/fused.py:483) runs them on a sharded lattice.
// The windows (f; for K7 and K5' also hij: the JAX stage's windows) are
// padded along x and/or y by the neighbours' rows and read unwrapped there
// (PAD, PkGeom in pk_common.cuh), by the Laplacians and the gradients;
// dfdt, the carries, dhijdt and the outputs are the full block, the region's
// rows from its first x row. The arithmetic is the unpadded kernel's, so a
// padded launch equals it on the whole lattice bit for bit, and an interior
// plus two shell launches equal a padded launch. K5 and K5' keep the padded
// launch on every mesh (the JAX package's rule for kernels with sums): a
// tile's partials go to the index the per-site block has in the whole
// lattice's launch, threads past the region's edge adding zeros, and the
// host runs the second launch once after every shard's first. Every
// padding also comes with bfloat16 carries (_bf16_xpad, ...; the energy
// stages also _bf16_fin_xpad, ...): the carries are full blocks here, read
// widened and stored rounded as unpadded, so a sharded bf16 launch equals
// the unpadded _bf16 (_bf16_fin) kernel on the whole lattice bit for bit.
#include "pk_common.cuh"

template <typename T>
struct PkStageParams {
  T dt, a, hubble, A, B;
  PkLapWeights<T> w;
  PkGradWeights<T> g;  // the GW variants only
};

// K2 per site (PK_STAGE_PER_SITE 1; see the file comment).
template <typename T, typename C, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
pk_fused_stage_kernel(PkArrays<T> io, int X, int Y, int Z,
                      PkStageParams<T> p, PkGeom g) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= Z || y >= Y) return;
  const T* __restrict__ f = io.in[0];
  const T* __restrict__ dfdt = io.in[1];
  const C* __restrict__ kf = pk_in_as<C>(io, 2);
  const C* __restrict__ kdf = pk_in_as<C>(io, 3);
  T* __restrict__ f_out = io.out[0];
  T* __restrict__ dfdt_out = io.out[1];
  C* __restrict__ kf_out = pk_out_as<C>(io, 2);
  C* __restrict__ kdf_out = pk_out_as<C>(io, 3);
  // the blockwise arrays and the window f, each with its own geometry
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const int64_t Nw = PAD ? g.Nw : N;
  const int Yw = PAD ? g.Ys : Y;
  const int64_t wsite = PAD ? ((int64_t)x * Yw + y) * Z + z : site;

  T fc[PK_F], lap[PK_F], dv[PK_F];
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    fc[c] = f[c * Nw + wsite];
    lap[c] = pk_lap<PAD>(PkLoad<T>{f + c * Nw, Yw, Z}, fc[c], x, y, z, X, Y,
                         Z, p.w);
  }
  pk_dvdf<T>(fc, p.a, p.hubble, dv);

  const T two_hub = T(2) * p.hubble;
  const T a2 = p.a * p.a;
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    const int64_t i = c * N + site;
    const T df0 = dfdt[i];
    const T rhs_df = (lap[c] - two_hub * df0) - a2 * dv[c];
    const T kf2 = p.A * PkCarry<T, C>::load(kf[i]) + p.dt * df0;
    const T kdf2 = p.A * PkCarry<T, C>::load(kdf[i]) + p.dt * rhs_df;
    f_out[i] = fc[c] + p.B * kf2;
    dfdt_out[i] = df0 + p.B * kdf2;
    kf_out[i] = PkCarry<T, C>::store(kf2);
    kdf_out[i] = PkCarry<T, C>::store(kdf2);
  }
}

// The tensor components the stage march of a variant holds: the model's
// with GW, none without (K5; a scalar library has no PK_NH).
#ifdef PK_NH
#define PK_STAGE_NH(GW) ((GW) ? PK_NH : 0)
#else
#define PK_STAGE_NH(GW) 0
#endif

// K2 and K5 march with the next plane's ring and frame loads a step ahead
// (pk_march's AHEAD): faster than without at every run length of
// chip_smoke.py --phases march_variants on an H100; K2 with bfloat16
// carries never does (4% faster without at each run length)
#ifndef PK_SCALAR_STAGE_AHEAD
#define PK_SCALAR_STAGE_AHEAD 1
#endif
// 1: K2 runs per site (pk_fused_stage_kernel), the yardstick build
#ifndef PK_STAGE_PER_SITE
#define PK_STAGE_PER_SITE 0
#endif

// The site values of the stage march, read from device memory with a
// plane's loads: dfdt, kf, kdfdt of each field (in the split layout also f,
// which dV/df and V read for every field), dhijdt, khij, kdhijdt of each
// component a pass holds (GW); the carries widened.
template <typename T, int G>
struct PkStageSite {
  T f[PK_F], df[PK_F], kf[PK_F], kdf[PK_F];
  T dh[G ? G : 1], kh[G ? G : 1], kdh[G ? G : 1];
};

// K5', K7, K5 and K2: the x-march (see the file comment), one template.
// ENERGY: the scalar sector's sum terms, per 32 x 8 tile (pk_march_sums);
// GW: the tensor stage. The shared arrays of a pass: f of each field it
// holds, then (GW) h of each component it holds.
template <typename T, typename C, typename KD, bool ENERGY, bool GW, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y, 1)
pk_stage_march_kernel(PkArrays<T> io, int X, int Y, int Z,
                      PkStageParams<T> p, T* __restrict__ partials,
                      int64_t nblocks, PkGeom g) {
  constexpr int NH = PK_STAGE_NH(GW);
  using Tl = PkMarchTile<T, NH, 1>;
  using Pass = PkMarchPass<T, NH, 1>;
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t Nw = PAD ? g.Nw : N;
  const int Yw = PAD ? g.Ys : Y;
  const PkMarchInputs<T, C, false> in{
      {io.in[0], io.in[4]}, {nullptr, nullptr}, {nullptr, nullptr},
      {nullptr, nullptr}, T(0), T(0), T(0), T(0), T(0)};
  const int z = blockIdx.x * Tl::TZ + threadIdx.x;
  const int y = blockIdx.y * Tl::TY + threadIdx.y;
  const bool valid = z < Z && y < Y;
  const int ctr = (threadIdx.y + PK_H) * Tl::SZ + threadIdx.x + PK_H;
  // split layout: grad f of every field at each plane of the run, parked
  // by the scalar passes for the tensor passes' S_ij
  T grads[GW && !Tl::JOINT ? Tl::LX : 1][PK_F][3];
  // unpadded, a plane's partials index the launch's own blocks
  if (!PAD) g = PkGeom{0, 0, 0, 0, 0, (Y + PK_BLOCK_Y - 1) / PK_BLOCK_Y};
  auto pre = [&](int x, const Pass ps) {
    PkStageSite<T, Tl::G> s{};
    if (!valid) return s;
    const int64_t site = ((int64_t)x * Y + y) * Z + z;
    if (ps.scalar) {
#pragma unroll
      for (int c = 0; c < PK_F; ++c) {
        if (!Tl::JOINT)
          s.f[c] = io.in[0][c * Nw + (PAD ? ((int64_t)x * Yw + y) * Z + z
                                          : site)];
        if (!ps.held(c)) continue;
        const int64_t i = c * N + site;
        s.df[c] = io.in[1][i];
        s.kf[c] = PkCarry<T, C>::load(pk_in_as<C>(io, 2)[i]);
        s.kdf[c] = PkCarry<T, KD>::load(pk_in_as<KD>(io, 3)[i]);
      }
    }
    if (ps.tensors()) {
#pragma unroll
      for (int j = 0; j < Tl::G; ++j) {
        const int64_t i = (ps.c0 + j) * N + site;
        s.dh[j] = io.in[5][i];
        s.kh[j] = PkCarry<T, C>::load(pk_in_as<C>(io, 6)[i]);
        s.kdh[j] = PkCarry<T, KD>::load(pk_in_as<KD>(io, 7)[i]);
      }
    }
    return s;
  };
  // K5's and K2's look-ahead; none for K2 with carries narrower than T
  // (bfloat16)
  constexpr bool AHEAD = !GW && PK_SCALAR_STAGE_AHEAD
                         && (ENERGY || sizeof(C) == sizeof(T));
  pk_march<T, NH, PAD, 1, AHEAD>(
      in, X, Y, Z, Nw, Yw, pre, [&](
      int x, int px, const Pass ps, const PkMarchView<T>& v,
      const PkStageSite<T, Tl::G>& s) {
    const int64_t site = ((int64_t)x * Y + y) * Z + z;
    const T two_hub = T(2) * p.hubble;
    if (ps.scalar) {
      // the scalar stage (K2's arithmetic) and its fields' sum terms
      T terms[PK_NT];
#pragma unroll
      for (int t = 0; t < PK_NT; ++t) terms[t] = T(0);
      if (valid) {
        T fc[PK_F], lap[PK_F], dv[PK_F];
#pragma unroll
        for (int c = 0; c < PK_F; ++c) {
          fc[c] = Tl::JOINT ? v.sm[c * Tl::SITES + ctr] : s.f[c];
          if (ps.held(c)) lap[c] = pk_march_lap(v, c - ps.k0, fc[c], p.w);
        }
        pk_dvdf<T>(fc, p.a, p.hubble, dv);
        const T a2 = p.a * p.a;
#pragma unroll
        for (int c = 0; c < PK_F; ++c) {
          if (!ps.held(c)) continue;
          const int64_t i = c * N + site;
          const T df0 = s.df[c];
          const T rhs_df = (lap[c] - two_hub * df0) - a2 * dv[c];
          const T kf2 = p.A * s.kf[c] + p.dt * df0;
          const T kdf2 = p.A * s.kdf[c] + p.dt * rhs_df;
          io.out[0][i] = fc[c] + p.B * kf2;
          io.out[1][i] = df0 + p.B * kdf2;
          pk_out_as<C>(io, 2)[i] = PkCarry<T, C>::store(kf2);
          pk_out_as<C>(io, 3)[i] = PkCarry<T, C>::store(kdf2);
          if (ENERGY) {
            terms[c] = df0 * df0;
            terms[PK_F + c] = (-fc[c]) * lap[c];
          }
        }
        if (ENERGY) terms[2 * PK_F] = pk_v<T>(fc, p.a, p.hubble);
      }
      // a scalar pass's terms: its fields', and the potential's in the
      // first
      if constexpr (ENERGY)
        pk_march_sums<T, PK_NT>(terms, partials, nblocks, g, x,
                                [&](int t) { return ps.sums(t); });
    }
#ifdef PK_NH
    if constexpr (GW) {
      if (!valid) return;
      // S_ij from grad f
      T sij[PK_NH];
      if constexpr (Tl::JOINT) {
        T dfdx[PK_F][3];
#pragma unroll
        for (int c = 0; c < PK_F; ++c) pk_march_grad(v, c, p.g, dfdx[c]);
        pk_sij<T>(dfdx, p.a, p.hubble, sij);
      } else if (ps.scalar) {
#pragma unroll
        for (int c = 0; c < PK_F; ++c)
          if (ps.held(c)) pk_march_grad(v, c - ps.k0, p.g, grads[px][c]);
      } else {
        pk_sij<T>(grads[px], p.a, p.hubble, sij);
      }
      if (!ps.tensors()) return;
#pragma unroll
      for (int j = 0; j < Tl::G; ++j) {
        const int c = ps.c0 + j;
        const int64_t i = c * N + site;
        const T h0 = v.sm[(Tl::HS + j) * Tl::SITES + ctr];
        const T lap_h = pk_march_lap(v, Tl::HS + j, h0, p.w);
        T h1, dh1, kh1, kdh1;
        pk_gw_stage(h0, s.dh[j], s.kh[j], s.kdh[j], lap_h, sij[c], p.A, p.B,
                    p.dt, two_hub, h1, dh1, kh1, kdh1);
        io.out[4][i] = h1;
        io.out[5][i] = dh1;
        pk_out_as<C>(io, 6)[i] = PkCarry<T, C>::store(kh1);
        pk_out_as<C>(io, 7)[i] = PkCarry<T, C>::store(kdh1);
      }
    }
#endif
  });
}

// ins / outs: host arrays of 4 (scalar) or 8 (GW: then hij, dhijdt, khij,
// kdhijdt) device pointers. params: dt, a, hubble, A, B, then the Laplacian
// weights (pk_lap_weights) and, for GW, the gradient weights
// (pk_grad_weights). With ENERGY, partials holds PK_NT * nblocks values and
// sums receives the PK_NT entry-state sums: unpadded, nblocks is
// pk_num_blocks(X, Y, Z) and the second launch follows; padded, nblocks is
// the whole lattice's count (PkGeom) and sums is null, the host finishing.
template <typename T, typename C, typename KD, bool ENERGY, bool GW,
          int PAD = 0>
static int pk_launch_stage(const void* const* ins, void* const* outs, int X,
                           int Y, int Z, const double* params,
                           void* partials, void* sums, void* stream,
                           PkGeom g = PkGeom{0, 0, 0, 0, 0, 0},
                           int64_t nblocks = 0) {
  PkStageParams<T> p;
  p.dt = T(params[0]);
  p.a = T(params[1]);
  p.hubble = T(params[2]);
  p.A = T(params[3]);
  p.B = T(params[4]);
  p.w = pk_lap_weights<T>(params + 5);
  if (GW) p.g = pk_grad_weights<T>(params + 5 + PK_NLAPW);
  if (!PAD) nblocks = pk_num_blocks(X, Y, Z);
  int rc;
  if constexpr (PK_STAGE_PER_SITE && !ENERGY && !GW) {
    pk_fused_stage_kernel<T, C, PAD>
        <<<pk_grid(X, Y, Z), dim3(PK_BLOCK_Z, PK_BLOCK_Y, 1), 0,
           (cudaStream_t)stream>>>(pk_arrays<T>(ins, outs, 4), X, Y, Z, p,
                                   g);
    rc = (int)cudaGetLastError();
  } else {
    rc = pk_march_launch<T, PK_STAGE_NH(GW), 1>(
        pk_stage_march_kernel<T, C, KD, ENERGY, GW, PAD>, X, Y, Z, stream,
        pk_arrays<T>(ins, outs, GW ? 8 : 4), X, Y, Z, p, (T*)partials,
        nblocks, g);
  }
  if (!ENERGY || PAD || rc != 0) return rc;
  return pk_finish_sums<T>(partials, sums, PK_NT, nblocks,
                           (cudaStream_t)stream);
}

#define PK_STAGE_ARGS                                                       \
  const void *const *ins, void *const *outs, int X, int Y, int Z,           \
      const double *params

// One entry point per (T, C, KD, ENERGY, GW) instantiation; the _bf16 ones
// store the carries in bfloat16, the _bf16_fin ones also read the velocity
// carries in T.
#define PK_STAGE_ENTRY(name, T, C, GW)                                      \
  extern "C" int name(PK_STAGE_ARGS, void* stream) {                        \
    return pk_launch_stage<T, C, C, false, GW>(ins, outs, X, Y, Z, params,  \
                                               nullptr, nullptr, stream);   \
  }
#define PK_STAGE_ENERGY_ENTRY(name, T, C, KD, GW)                           \
  extern "C" int name(PK_STAGE_ARGS, void* partials, void* sums,            \
                      void* stream) {                                       \
    return pk_launch_stage<T, C, KD, true, GW>(ins, outs, X, Y, Z, params,  \
                                               partials, sums, stream);     \
  }
// The sharded tier: a stage on windows padded along x, y or both (interior
// and shell launches take the x-padded entry point). partials, nblocks (the
// sum kernels only; null and 0 otherwise) and Nb, Nw, Ys, x0, yb0, GYb
// (PkGeom): the same arguments for every padded entry point of the fused
// sources.
#define PK_PAD_ARGS                                                         \
  PK_STAGE_ARGS, void *partials, int64_t nblocks, int64_t Nb, int64_t Nw,   \
      int Ys, int x0, int yb0, int GYb, void *stream
#define PK_STAGE_PAD_ENTRY(name, T, C, KD, ENERGY, GW, PAD)                \
  extern "C" int name(PK_PAD_ARGS) {                                        \
    return pk_launch_stage<T, C, KD, ENERGY, GW, PAD>(                      \
        ins, outs, X, Y, Z, params, partials, nullptr, stream,              \
        PkGeom{Nb, Nw, Ys, x0, yb0, GYb}, nblocks);                         \
  }
// the three paddings of one (T, C, KD) instantiation
#define PK_STAGE_PADS(name, T, C, KD, ENERGY, GW)                           \
  PK_STAGE_PAD_ENTRY(name##_xpad, T, C, KD, ENERGY, GW, PK_PAD_X)           \
  PK_STAGE_PAD_ENTRY(name##_ypad, T, C, KD, ENERGY, GW, PK_PAD_Y)           \
  PK_STAGE_PAD_ENTRY(name##_xypad, T, C, KD, ENERGY, GW,                    \
                     PK_PAD_X | PK_PAD_Y)
// f32 and f64, the carries in T and in bfloat16 (_bf16)
#define PK_STAGE_PAD_ENTRIES(name, ENERGY, GW)                              \
  PK_STAGE_PADS(name##_f32, float, float, float, ENERGY, GW)                \
  PK_STAGE_PADS(name##_f64, double, double, double, ENERGY, GW)             \
  PK_STAGE_PADS(name##_f32_bf16, float, PK_BF16, PK_BF16, ENERGY, GW)       \
  PK_STAGE_PADS(name##_f64_bf16, double, PK_BF16, PK_BF16, ENERGY, GW)
// the energy stages on finalized carries (_bf16_fin): the velocity carries
// in T, the others in bfloat16
#define PK_STAGE_FIN_PAD_ENTRIES(name, GW)                                  \
  PK_STAGE_PADS(name##_f32_bf16_fin, float, PK_BF16, float, true, GW)       \
  PK_STAGE_PADS(name##_f64_bf16_fin, double, PK_BF16, double, true, GW)
#define PK_BF16 __nv_bfloat16

PK_FINISH_ENTRIES
PK_SCALAR_STAGE_MARCH_ENTRY

PK_STAGE_ENTRY(pk_fused_stage_f32, float, float, false)
PK_STAGE_ENTRY(pk_fused_stage_f64, double, double, false)
PK_STAGE_ENTRY(pk_fused_stage_f32_bf16, float, PK_BF16, false)
PK_STAGE_ENTRY(pk_fused_stage_f64_bf16, double, PK_BF16, false)
PK_STAGE_PAD_ENTRIES(pk_fused_stage, false, false)
PK_STAGE_PAD_ENTRIES(pk_fused_stage_energy, true, false)
PK_STAGE_FIN_PAD_ENTRIES(pk_fused_stage_energy, false)
PK_STAGE_ENERGY_ENTRY(pk_fused_stage_energy_f32, float, float, float, false)
PK_STAGE_ENERGY_ENTRY(pk_fused_stage_energy_f64, double, double, double,
                      false)
PK_STAGE_ENERGY_ENTRY(pk_fused_stage_energy_f32_bf16, float, PK_BF16,
                      PK_BF16, false)
PK_STAGE_ENERGY_ENTRY(pk_fused_stage_energy_f64_bf16, double, PK_BF16,
                      PK_BF16, false)
PK_STAGE_ENERGY_ENTRY(pk_fused_stage_energy_f32_bf16_fin, float, PK_BF16,
                      float, false)
PK_STAGE_ENERGY_ENTRY(pk_fused_stage_energy_f64_bf16_fin, double, PK_BF16,
                      double, false)

#ifdef PK_NH
PK_STAGE_MARCH_ENTRY
PK_STAGE_ENTRY(pk_preheat_stage_f32, float, float, true)
PK_STAGE_ENTRY(pk_preheat_stage_f64, double, double, true)
PK_STAGE_ENTRY(pk_preheat_stage_f32_bf16, float, PK_BF16, true)
PK_STAGE_ENTRY(pk_preheat_stage_f64_bf16, double, PK_BF16, true)
PK_STAGE_PAD_ENTRIES(pk_preheat_stage, false, true)
PK_STAGE_PAD_ENTRIES(pk_preheat_stage_energy, true, true)
PK_STAGE_FIN_PAD_ENTRIES(pk_preheat_stage_energy, true)
PK_STAGE_ENERGY_ENTRY(pk_preheat_stage_energy_f32, float, float, float, true)
PK_STAGE_ENERGY_ENTRY(pk_preheat_stage_energy_f64, double, double, double,
                      true)
PK_STAGE_ENERGY_ENTRY(pk_preheat_stage_energy_f32_bf16, float, PK_BF16,
                      PK_BF16, true)
PK_STAGE_ENERGY_ENTRY(pk_preheat_stage_energy_f64_bf16, double, PK_BF16,
                      PK_BF16, true)
PK_STAGE_ENERGY_ENTRY(pk_preheat_stage_energy_f32_bf16_fin, float, PK_BF16,
                      float, true)
PK_STAGE_ENERGY_ENTRY(pk_preheat_stage_energy_f64_bf16_fin, double, PK_BF16,
                      double, true)
#endif
