// K6: the deferred-drag coupled stage pair, for the energy-coupled driver
// (FusedScalarStepper.coupled_multi_step); K9: the same for the scalar +
// gravitational-wave system (FusedPreheatStepper.coupled_multi_step).
//
// K6 replaces the Pallas body FusedScalarStepper._deferred_body /
// _deferred_pair_core (+ _completed_taps, _axpy_taps, _esums, _dV) of
// pystella_tpu/ops/fused.py, in both variants _build_coupled_pair_call
// builds, with the sums of StreamingStencil._accumulate_sums
// (pystella_tpu/ops/pallas_stencil.py). It is K3 (fused_pair.cu) with two
// changes that let the Friedmann background advance exactly between
// launches:
//
// - stage 2 is everything but its Hubble drag: kf2 = A2*kf1 + dt*df1,
//   f2 = f1 + B2*kf2, kdfp = A2*kdf1 + dt*(lap f1 - a2*a2*dV(f1)), with dV
//   evaluated without hubble (pk_dvdf_nohub). The outputs are f2, dfp = df1,
//   kf2 and kdfp; the drag -2*dt*hubble2*df1 is completed by the next launch
//   (or the chunk-end finalize, a plain elementwise pass) once hubble2 is
//   known;
// - it emits two sets of energy sums: esums1 of the entry state (f0, df0,
//   lap f0 at a1, hubble1) and esums2 of the stage-1 state (f1, df1, lap f1
//   at a2, no hubble), lap f1 being the Laplacian of the composed f1.
//
// IN_DEFERRED selects the input:
// - false ("normal", a chunk's first pair): f, dfdt, kf, kdfdt;
// - true: the previous pair's f, dfp, kdfp, kf, with scalars hubfix and B2p.
//   The incoming carry is kdf0 = kdfp - (2*dt*hubfix)*dfp, the velocity
//   df0 = dfp + B2p*kdf0, and wherever the stage-1 composition reads the
//   velocity it is completed the same way (_completed_taps' arithmetic), so
//   the pair equals the one that would have run with the completed state as
//   input.
//
// K9 (GW = true) replaces the Pallas body FusedPreheatStepper._deferred_body
// (pystella_tpu/ops/fused.py:1891), run by StreamingStencil._build
// (pystella_tpu/ops/pallas_stencil.py:709) and, sharded, _build_xhalo
// (:789): K6 on f (the same two sum sets, of the scalar sector only), then
// per hij component the tensor pair with the same deferral -- stage 1 as in
// K8 (S_ij1 from grad f), stage 2 without its Hubble drag, kdhp = A2*kdh1 +
// dt*(lap h1 + 16 pi S_ij2) with S_ij2 from grad f1 and printed without
// hubble (pk_sij_nohub); the outputs hij2, dhp = dh1, khij2, kdhp. With
// IN_DEFERRED the tensor inputs are hij, dhp, kdhp, khij, and dhp is
// completed like dfp, at the site and wherever h1 is composed.
//
// With bfloat16 carries (C = __nv_bfloat16, the _bf16 entry points) the
// carries kf, kdfdt (deferred input: kdfp, kf) and their tensor counterparts
// are read widened to T, at the site and at every tap that reads them, and
// only the stored outputs kf2, kdfp (kh2, kdhp) are rounded, after f2 (h2)
// has been formed: the order of the JAX package's _quantize_carries. The
// velocities dfp, dhp are state, not carries, and stay in T; the sums come
// from the widened values.
//
// Bound: memory, as K3: four arrays read and four written per site (8 * F *
// sites * sizeof(T) bytes for two stages; K9 8 * (F + 6)), plus one partial
// per sum term and 32 x 8 tile. K6 and K9 run the x-march of pk_common.cuh
// (pk_march; see fused_pair.cu's K3 and K8): the shared planes hold f and
// f1 (K9 also h and h1), composed once an element (the velocity completed
// first for a deferred input: PkMarchInputs::composed), and each
// plane's sums are reduced per 32 x 8 tile in a fixed tree and
// written where a per-site launch's block of that plane wrote them
// (pk_march_sums), so the sums, like the lattice outputs, are those of the
// per-site arithmetic bit for bit. -fmad=false; outputs to separate
// buffers; the tensor components one after another; the sums reduced in a
// fixed order in T (pk_finish_sums).
//
// The sharded tier (the _xpad, _ypad, _xypad entry points of both variants
// of K6 and K9) replaces StreamingStencil._build_xhalo
// (pystella_tpu/ops/pallas_stencil.py:789) on _deferred_body, as _make_call
// (pystella_tpu/ops/fused.py:483) runs it on a sharded lattice: always the
// padded launch (a kernel with sums takes no interior/shell split there).
// The windows are the JAX pair's (_def_win_defs, pystella_tpu/ops/fused.py:
// 1272 and :1847): normal input f, dfdt, kf (and hij, dhijdt, khij), read
// through a window's geometry, kdfdt (kdhijdt) the full block; deferred
// input all four (eight), every one a window, since the completed velocity
// is composed at every tap from dfp and kdfp. The arithmetic is the
// unpadded kernel's, and each plane's tiles' partials go to the index they
// have in the whole lattice's per-site launch (pk_march_sums), so the
// padded launches of every shard followed by one second launch equal the
// unpadded kernel, sums included, bit for bit. With bfloat16 carries
// (_bf16_xpad, ...) the carry windows (kf; deferred input also kdfp;
// their tensor counterparts) are padded in bfloat16 and read as C with the
// window's geometry, counted in elements of C.
#include "pk_common.cuh"

#ifdef PK_HUBBLE_FREE

template <typename T>
struct PkCoupledParams {
  T dt, a1, hubble1, A1, B1, a2, A2, B2, hubfix, B2p;
  PkLapWeights<T> w;
  PkGradWeights<T> g;  // K9 only
};

// The x-march (pk_march, pk_common.cuh) of K6 and K9. Per plane and site,
// K6's arithmetic on f (pk_coupled_scalar) -- lap f and lap f1 from the
// shared f and f1 planes, the two sum sets --; for K9 then S_ij of both
// stages from grad f and grad f1, then per hij component the tensor pair
// with stage 2's drag deferred, lap h and lap h1 from the shared h and h1
// planes. The site's own velocity and carries (in the split layout also
// f) are read from device memory with the plane's loads (PkCoupledSite)
// and completed at the site for a deferred input; in the joint layout f
// and hij come from the centre plane. Each plane's sums go where a
// per-site launch's block of that plane puts them (pk_march_sums): in the
// split layout each scalar pass writes its fields' terms, the first also
// the potential's. So the two launches give the sums of the per-site
// arithmetic bit for bit.
template <typename T, int G>
struct PkCoupledSite {
  // normal input: dfdt, kf, kdfdt; deferred: dfp, kdfp, kf (widened)
  T f[PK_F], a[PK_F], b[PK_F], c[PK_F];
  T ha[G], hb[G], hc[G];  // the same for each hij held
};

template <typename T>
struct PkCoupledSite<T, 0> {
  T f[PK_F], a[PK_F], b[PK_F], c[PK_F];
};

// A scalar pass's site values: window index wsite, block index site.
template <typename C, bool IN_DEFERRED, bool JOINT, typename T, typename S>
__device__ __forceinline__ void pk_coupled_site(const PkArrays<T>& io,
                                                int64_t wsite, int64_t site,
                                                int64_t Nw, int64_t N,
                                                S& s) {
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    const int64_t wi = c * Nw + wsite;
    if (!JOINT) s.f[c] = io.in[0][wi];
    s.a[c] = io.in[1][wi];
    s.b[c] = PkCarry<T, C>::load(pk_in_as<C>(io, 2)[wi]);
    s.c[c] = PkCarry<T, C>::load(
        pk_in_as<C>(io, 3)[IN_DEFERRED ? wi : c * N + site]);
  }
}

// K6's pair at the thread's site (block index site; ctr its place in the
// centre plane) in scalar pass ps, its sum terms into terms (esums1 in
// [0, PK_NT), esums2 in [PK_NT, 2 PK_NT)): stage 1 with the arithmetic
// of fused_pair.cu (exact scalars), stage 2 with lap f1 from the shared
// f1 and its Hubble drag deferred.
template <typename C, bool IN_DEFERRED, typename T, typename Pass,
          typename S>
__device__ __forceinline__ void pk_coupled_scalar(
    const PkArrays<T>& io, int64_t site, int64_t N, const Pass ps,
    const PkMarchView<T>& v, const S& s, const PkCoupledParams<T>& p,
    T c_def, int ctr, T (&terms)[2 * PK_NT]) {
  using Tl = typename Pass::Tl;
  constexpr int F1 = Tl::GF;
  // normal: a, b, c = dfdt, kf, kdfdt; deferred: dfp, kdfp, kf
  T f0[PK_F], df0[PK_F], kdf0[PK_F], kf1[PK_F], f1[PK_F], kdf1[PK_F];
  T df1[PK_F], lap[PK_F], dv[PK_F];
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    f0[c] = Tl::JOINT ? v.sm[c * Tl::SITES + ctr] : s.f[c];
    T kf;
    if (IN_DEFERRED) {
      const T d = s.a[c];
      kdf0[c] = s.b[c] - c_def * d;
      df0[c] = d + p.B2p * kdf0[c];
      kf = s.c[c];
    } else {
      df0[c] = s.a[c];
      kdf0[c] = s.c[c];
      kf = s.b[c];
    }
    if (ps.held(c)) lap[c] = pk_march_lap(v, c - ps.k0, f0[c], p.w);
    kf1[c] = p.A1 * kf + p.dt * df0[c];
    f1[c] = f0[c] + p.B1 * kf1[c];
  }
  pk_dvdf<T>(f0, p.a1, p.hubble1, dv);
  {
    const T two_hub = T(2) * p.hubble1;
    const T a1sq = p.a1 * p.a1;
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      if (!ps.held(c)) continue;
      kdf1[c] = p.A1 * kdf0[c]
                + p.dt * ((lap[c] - two_hub * df0[c]) - a1sq * dv[c]);
      df1[c] = df0[c] + p.B1 * kdf1[c];
      terms[c] = df0[c] * df0[c];
      terms[PK_F + c] = (-f0[c]) * lap[c];
    }
  }
  terms[2 * PK_F] = pk_v<T>(f0, p.a1, p.hubble1);
  // the stage-2 Laplacian, from the shared f1
#pragma unroll
  for (int c = 0; c < PK_F; ++c)
    if (ps.held(c)) lap[c] = pk_march_lap(v, F1 + c - ps.k0, f1[c], p.w);
  // stage 2 on the site, its Hubble drag deferred
  pk_dvdf_nohub<T>(f1, p.a2, dv);
  const T a2sq = p.a2 * p.a2;
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    if (!ps.held(c)) continue;
    const int64_t i = c * N + site;
    const T kf2 = p.A2 * kf1[c] + p.dt * df1[c];
    io.out[0][i] = f1[c] + p.B2 * kf2;
    io.out[1][i] = df1[c];
    pk_out_as<C>(io, 2)[i] = PkCarry<T, C>::store(kf2);
    pk_out_as<C>(io, 3)[i] = PkCarry<T, C>::store(
        p.A2 * kdf1[c] + p.dt * (lap[c] - a2sq * dv[c]));
    terms[PK_NT + c] = df1[c] * df1[c];
    terms[PK_NT + PK_F + c] = (-f1[c]) * lap[c];
  }
  terms[PK_NT + 2 * PK_F] = pk_v_nohub<T>(f1, p.a2);
}

// K6: the scalar march (no tensor components).
template <typename T, typename C, bool IN_DEFERRED, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y, 1)
pk_coupled_pair_kernel(PkArrays<T> io, int X, int Y, int Z,
                       PkCoupledParams<T> p, T* __restrict__ partials,
                       int64_t nblocks, PkGeom g) {
  using Tl = PkMarchTile<T, 0>;
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t Nw = PAD ? g.Nw : N;
  const int Yw = PAD ? g.Ys : Y;
  const T c_def = (T(2) * p.dt) * p.hubfix;
  // normal: in0..3 = f, dfdt, kf, kdfdt; deferred: f, dfp, kdfp, kf (the
  // last two carries, stored in C)
  const PkMarchInputs<T, C, IN_DEFERRED> in{
      {io.in[0], nullptr}, {io.in[1], nullptr},
      {pk_in_as<C>(io, IN_DEFERRED ? 3 : 2), nullptr},
      {IN_DEFERRED ? pk_in_as<C>(io, 2) : nullptr, nullptr},
      p.B1, p.A1, p.dt, p.B2p, c_def};
  const int z = blockIdx.x * Tl::TZ + threadIdx.x;
  const int y = blockIdx.y * Tl::TY + threadIdx.y;
  const bool valid = z < Z && y < Y;
  const int ctr = (threadIdx.y + PK_H) * Tl::SZ + threadIdx.x + PK_H;
  // unpadded, a plane's partials index the launch's own blocks
  if (!PAD) g = PkGeom{0, 0, 0, 0, 0, (Y + PK_BLOCK_Y - 1) / PK_BLOCK_Y};
  auto pre = [&](int x, const PkMarchPass<T, 0>) {
    PkCoupledSite<T, 0> s{};
    if (!valid) return s;
    const int64_t site = ((int64_t)x * Y + y) * Z + z;
    const int64_t wsite = PAD ? ((int64_t)x * Yw + y) * Z + z : site;
    pk_coupled_site<C, IN_DEFERRED, Tl::JOINT>(io, wsite, site, Nw, N, s);
    return s;
  };
  pk_march<T, 0, PAD>(in, X, Y, Z, Nw, Yw, pre, [&](
      int x, int, const PkMarchPass<T, 0> ps, const PkMarchView<T>& v,
      const PkCoupledSite<T, 0>& s) {
    T terms[2 * PK_NT];
#pragma unroll
    for (int t = 0; t < 2 * PK_NT; ++t) terms[t] = T(0);
    if (valid)
      pk_coupled_scalar<C, IN_DEFERRED>(io, ((int64_t)x * Y + y) * Z + z,
                                        N, ps, v, s, p, c_def, ctr, terms);
    pk_march_sums<T, 2 * PK_NT>(terms, partials, nblocks, g, x,
                                [&](int t) { return ps.sums(t); });
  });
}

#ifdef PK_NH
// K9: the march with the tensor components.
template <typename T, typename C, bool IN_DEFERRED, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y, 1)
pk_preheat_coupled_pair_kernel(PkArrays<T> io, int X, int Y, int Z,
                               PkCoupledParams<T> p,
                               T* __restrict__ partials, int64_t nblocks,
                               PkGeom g) {
  using Tl = PkMarchTile<T, PK_NH>;
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t Nw = PAD ? g.Nw : N;
  const int Yw = PAD ? g.Ys : Y;
  const T c_def = (T(2) * p.dt) * p.hubfix;
  // normal: in0..3 = f, dfdt, kf, kdfdt; deferred: f, dfp, kdfp, kf
  // (the last two carries, stored in C); in4..7 likewise for hij
  const PkMarchInputs<T, C, IN_DEFERRED> in{
      {io.in[0], io.in[4]}, {io.in[1], io.in[5]},
      {pk_in_as<C>(io, IN_DEFERRED ? 3 : 2),
       pk_in_as<C>(io, IN_DEFERRED ? 7 : 6)},
      {IN_DEFERRED ? pk_in_as<C>(io, 2) : nullptr,
       IN_DEFERRED ? pk_in_as<C>(io, 6) : nullptr},
      p.B1, p.A1, p.dt, p.B2p, c_def};
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
  // unpadded, a plane's partials index the launch's own blocks
  if (!PAD) g = PkGeom{0, 0, 0, 0, 0, (Y + PK_BLOCK_Y - 1) / PK_BLOCK_Y};
  auto pre = [&](int x, const PkMarchPass<T, PK_NH> ps) {
    PkCoupledSite<T, Tl::G> s{};
    if (!valid) return s;
    const int64_t site = ((int64_t)x * Y + y) * Z + z;
    const int64_t wsite = PAD ? ((int64_t)x * Yw + y) * Z + z : site;
    if (ps.scalar)
      pk_coupled_site<C, IN_DEFERRED, Tl::JOINT>(io, wsite, site, Nw, N, s);
    if (ps.tensors()) {
#pragma unroll
      for (int j = 0; j < Tl::G; ++j) {
        const int c = ps.c0 + j;
        const int64_t wi = c * Nw + wsite;
        s.ha[j] = io.in[5][wi];
        s.hb[j] = PkCarry<T, C>::load(pk_in_as<C>(io, 6)[wi]);
        s.hc[j] = PkCarry<T, C>::load(
            pk_in_as<C>(io, 7)[IN_DEFERRED ? wi : c * N + site]);
      }
    }
    return s;
  };
  pk_march<T, PK_NH, PAD>(in, X, Y, Z, Nw, Yw, pre, [&](
      int x, int px, const PkMarchPass<T, PK_NH> ps,
      const PkMarchView<T>& v, const PkCoupledSite<T, Tl::G>& s) {
    // esums1 in terms[0, PK_NT), esums2 in terms[PK_NT, 2 PK_NT)
    T terms[2 * PK_NT];
#pragma unroll
    for (int t = 0; t < 2 * PK_NT; ++t) terms[t] = T(0);
    const int64_t site = ((int64_t)x * Y + y) * Z + z;
    if (valid && ps.scalar)
      pk_coupled_scalar<C, IN_DEFERRED>(io, site, N, ps, v, s, p, c_def,
                                        ctr, terms);
    if (valid) {
      // S_ij of both stages: from grad f and grad f1
      T sij1[PK_NH], sij2[PK_NH];
      if constexpr (Tl::JOINT) {
        T dfdx[PK_F][3];
#pragma unroll
        for (int c = 0; c < PK_F; ++c) pk_march_grad(v, c, p.g, dfdx[c]);
        pk_sij<T>(dfdx, p.a1, p.hubble1, sij1);
#pragma unroll
        for (int c = 0; c < PK_F; ++c)
          pk_march_grad(v, F1 + c, p.g, dfdx[c]);
        pk_sij_nohub<T>(dfdx, p.a2, sij2);
      } else if (ps.scalar) {
#pragma unroll
        for (int c = 0; c < PK_F; ++c) {
          if (!ps.held(c)) continue;
          pk_march_grad(v, c - ps.k0, p.g, grads[px][0][c]);
          pk_march_grad(v, F1 + c - ps.k0, p.g, grads[px][1][c]);
        }
      } else {
        pk_sij<T>(grads[px][0], p.a1, p.hubble1, sij1);
        pk_sij_nohub<T>(grads[px][1], p.a2, sij2);
      }

      const T two_hub1 = T(2) * p.hubble1;
#pragma unroll
      for (int j = 0; j < Tl::G; ++j) {
        if (!ps.tensors()) break;
        const int c = ps.c0 + j;
        const int64_t i = c * N + site;
        const T h0 = v.sm[(H0 + j) * Tl::SITES + ctr];
        // normal: ha, hb, hc = dhijdt, khij, kdhijdt; deferred: dhp,
        // kdhp, khij
        T dh0, kdh0, kh;
        if (IN_DEFERRED) {
          const T d = s.ha[j];
          kdh0 = s.hb[j] - c_def * d;
          dh0 = d + p.B2p * kdh0;
          kh = s.hc[j];
        } else {
          dh0 = s.ha[j];
          kdh0 = s.hc[j];
          kh = s.hb[j];
        }
        const T lap_h = pk_march_lap(v, H0 + j, h0, p.w);
        T h1, dh1, kh1, kdh1;
        pk_gw_stage(h0, dh0, kh, kdh0, lap_h, sij1[c], p.A1, p.B1, p.dt,
                    two_hub1, h1, dh1, kh1, kdh1);
        const T lap_h1 = pk_march_lap(v, H1 + j, h1, p.w);
        // tensor stage 2 with the Hubble drag deferred
        const T kh2 = p.A2 * kh1 + p.dt * dh1;
        io.out[4][i] = h1 + p.B2 * kh2;
        io.out[5][i] = dh1;
        pk_out_as<C>(io, 6)[i] = PkCarry<T, C>::store(kh2);
        pk_out_as<C>(io, 7)[i] = PkCarry<T, C>::store(
            p.A2 * kdh1 + p.dt * (lap_h1 + T(PK_GW_COEF) * sij2[c]));
      }
    }
    // a scalar pass's terms: its fields', and the potential's in the first
    if (ps.scalar)
      pk_march_sums<T, 2 * PK_NT>(terms, partials, nblocks, g, x,
                                  [&](int t) { return ps.sums(t); });
  });
}
#endif

// ins / outs: host arrays of 4 (scalar) or 8 (GW: then the tensor system's
// four, in the same roles) device pointers. params: dt, a1, hubble1, A1, B1,
// a2, A2, B2, [hubfix, B2p if IN_DEFERRED], then the Laplacian weights
// (pk_lap_weights) and, for GW, the gradient weights (pk_grad_weights).
// partials holds 2 * PK_NT * nblocks values; sums receives esums1 then
// esums2, PK_NT each: unpadded, nblocks is pk_num_blocks(X, Y, Z) and the
// second launch follows; padded, nblocks is the whole lattice's count
// (PkGeom) and sums is null, the host finishing.
template <typename T, typename C, bool IN_DEFERRED, bool GW, int PAD = 0>
static int pk_launch_coupled(const void* const* ins, void* const* outs,
                             int X, int Y, int Z, const double* params,
                             void* partials, void* sums, void* stream,
                             PkGeom g = PkGeom{0, 0, 0, 0, 0, 0},
                             int64_t nblocks = 0) {
  PkCoupledParams<T> p;
  p.dt = T(params[0]);
  p.a1 = T(params[1]);
  p.hubble1 = T(params[2]);
  p.A1 = T(params[3]);
  p.B1 = T(params[4]);
  p.a2 = T(params[5]);
  p.A2 = T(params[6]);
  p.B2 = T(params[7]);
  int n = 8;
  p.hubfix = T(0);
  p.B2p = T(0);
  if (IN_DEFERRED) {
    p.hubfix = T(params[8]);
    p.B2p = T(params[9]);
    n = 10;
  }
  p.w = pk_lap_weights<T>(params + n);
  if (!PAD) nblocks = pk_num_blocks(X, Y, Z);
  int rc;
#ifdef PK_NH
  if constexpr (GW) {
    p.g = pk_grad_weights<T>(params + n + PK_NLAPW);
    rc = pk_march_launch<T, PK_NH>(
        pk_preheat_coupled_pair_kernel<T, C, IN_DEFERRED, PAD>, X, Y, Z,
        stream, pk_arrays<T>(ins, outs, 8), X, Y, Z, p, (T*)partials,
        nblocks, g);
  } else
#endif
  rc = pk_march_launch<T, 0>(
      pk_coupled_pair_kernel<T, C, IN_DEFERRED, PAD>, X, Y, Z, stream,
      pk_arrays<T>(ins, outs, 4), X, Y, Z, p, (T*)partials, nblocks, g);
  if (PAD || rc != 0) return rc;
  return pk_finish_sums<T>(partials, sums, 2 * PK_NT, nblocks,
                           (cudaStream_t)stream);
}

#define PK_COUPLED_ARGS                                                     \
  const void *const *ins, void *const *outs, int X, int Y, int Z,           \
      const double *params, void *partials, void *sums, void *stream
#define PK_COUPLED_CALL (ins, outs, X, Y, Z, params, partials, sums, stream)

// One entry point per (T, C, IN_DEFERRED, GW) instantiation; the _bf16 ones
// store the carries in bfloat16.
#define PK_COUPLED_ENTRY(name, T, C, IN_DEFERRED, GW)                       \
  extern "C" int name(PK_COUPLED_ARGS) {                                    \
    return pk_launch_coupled<T, C, IN_DEFERRED, GW> PK_COUPLED_CALL;        \
  }
// The sharded tier: the padded launch, with the arguments of every padded
// entry point of the fused sources (fused_stage.cu): partials, nblocks, then
// Nb, Nw, Ys, x0, yb0, GYb (PkGeom).
#define PK_COUPLED_PAD_ENTRY(name, T, C, IN_DEFERRED, GW, PAD)              \
  extern "C" int name(const void* const* ins, void* const* outs, int X,     \
                      int Y, int Z, const double* params, void* partials,   \
                      int64_t nblocks, int64_t Nb, int64_t Nw, int Ys,      \
                      int x0, int yb0, int GYb, void* stream) {             \
    return pk_launch_coupled<T, C, IN_DEFERRED, GW, PAD>(                   \
        ins, outs, X, Y, Z, params, partials, nullptr, stream,              \
        PkGeom{Nb, Nw, Ys, x0, yb0, GYb}, nblocks);                         \
  }
// the three paddings of one (T, C) instantiation
#define PK_COUPLED_PADS(name, T, C, IN_DEFERRED, GW)                        \
  PK_COUPLED_PAD_ENTRY(name##_xpad, T, C, IN_DEFERRED, GW, PK_PAD_X)        \
  PK_COUPLED_PAD_ENTRY(name##_ypad, T, C, IN_DEFERRED, GW, PK_PAD_Y)        \
  PK_COUPLED_PAD_ENTRY(name##_xypad, T, C, IN_DEFERRED, GW,                 \
                       PK_PAD_X | PK_PAD_Y)
// f32 and f64, the carries in T and in bfloat16 (_bf16)
#define PK_COUPLED_PAD_ENTRIES(name, IN_DEFERRED, GW)                       \
  PK_COUPLED_PADS(name##_f32, float, float, IN_DEFERRED, GW)                \
  PK_COUPLED_PADS(name##_f64, double, double, IN_DEFERRED, GW)              \
  PK_COUPLED_PADS(name##_f32_bf16, float, PK_BF16, IN_DEFERRED, GW)         \
  PK_COUPLED_PADS(name##_f64_bf16, double, PK_BF16, IN_DEFERRED, GW)
#define PK_BF16 __nv_bfloat16

PK_FINISH_ENTRIES
PK_SCALAR_MARCH_ENTRY

PK_COUPLED_ENTRY(pk_coupled_pair_f32, float, float, false, false)
PK_COUPLED_ENTRY(pk_coupled_pair_f64, double, double, false, false)
PK_COUPLED_ENTRY(pk_coupled_pair_deferred_f32, float, float, true, false)
PK_COUPLED_ENTRY(pk_coupled_pair_deferred_f64, double, double, true, false)
PK_COUPLED_ENTRY(pk_coupled_pair_f32_bf16, float, PK_BF16, false, false)
PK_COUPLED_ENTRY(pk_coupled_pair_f64_bf16, double, PK_BF16, false, false)
PK_COUPLED_ENTRY(pk_coupled_pair_deferred_f32_bf16, float, PK_BF16, true,
                 false)
PK_COUPLED_ENTRY(pk_coupled_pair_deferred_f64_bf16, double, PK_BF16, true,
                 false)
PK_COUPLED_PAD_ENTRIES(pk_coupled_pair, false, false)
PK_COUPLED_PAD_ENTRIES(pk_coupled_pair_deferred, true, false)

#ifdef PK_NH
PK_COUPLED_ENTRY(pk_preheat_coupled_pair_f32, float, float, false, true)
PK_COUPLED_ENTRY(pk_preheat_coupled_pair_f64, double, double, false, true)
PK_COUPLED_ENTRY(pk_preheat_coupled_pair_deferred_f32, float, float, true,
                 true)
PK_COUPLED_ENTRY(pk_preheat_coupled_pair_deferred_f64, double, double, true,
                 true)
PK_COUPLED_ENTRY(pk_preheat_coupled_pair_f32_bf16, float, PK_BF16, false,
                 true)
PK_COUPLED_ENTRY(pk_preheat_coupled_pair_f64_bf16, double, PK_BF16, false,
                 true)
PK_COUPLED_ENTRY(pk_preheat_coupled_pair_deferred_f32_bf16, float, PK_BF16,
                 true, true)
PK_COUPLED_ENTRY(pk_preheat_coupled_pair_deferred_f64_bf16, double, PK_BF16,
                 true, true)
PK_COUPLED_PAD_ENTRIES(pk_preheat_coupled_pair, false, true)
PK_COUPLED_PAD_ENTRIES(pk_preheat_coupled_pair_deferred, true, true)
#endif

#else
#error "fused_coupled_pair.cu needs a model whose V and dV/df do not read hubble"
#endif
