// K11: one multigrid sweep over a level: mg_smooth (one Jacobi or Newton
// relaxation sweep of every unknown), mg_residual (rho - L(f)) and mg_tau
// (the FAS coarse right-hand side, restricted residual + L(f)).
//
// Replaces the Pallas body of RelaxationBase._pallas_level
// (pystella_tpu/multigrid/relax.py, kinds "smooth", "residual" and "tau"),
// run by StreamingStencil / ResidentStencil
// (pystella_tpu/ops/pallas_stencil.py). Per site:
//
//   lap_i = order-2h Laplacian of unknown i (pk_lap: lap_from_taps order)
//   out_i = expr_i(f, lap, rho, aux, omega, lap_diag)   for every unknown
//
// with expr the solver's symbolic update printed into the generated header
// (ops/codegen.py:relax_header): mg_step for the sweep, mg_resid for the
// residual, and for tau rho_i + mg_lhs (the restricted residual rides the
// rho slot, as in the JAX body). Every update reads the OLD values of all
// unknowns (Jacobi), so a sweep writes a second set of arrays; nu sweeps
// are nu launches that ping-pong two sets, with no host sync between them
// (the JAX kernel's runtime-count fori_loop).
//
// The Laplacian weights and its centre weight lap_diag depend on the
// level's spacing and the lattice shape on the level, so all are launch
// arguments: one library serves every level of a cycle. omega and lap_diag
// are doubles, which the printed expressions cast to T where the plain
// version's Python floats meet a tensor.
//
// Bound: memory. Per sweep each unknown, each rho and each lattice aux array
// is read once and each unknown written once ((3 nf + naux) * sites *
// sizeof(T) bytes) against ~10 + 9h operations plus the printed update per
// unknown. Design: pk_queue_march of pk_common.cuh over the MG_NF unknowns
// (mg_relax_march_kernel), the TPU builder's x ring carried to a block, as
// fd_ops.cu's Laplacian marches: a block of 32 (z) x 8 (y) threads walks a
// y-z tile along x over a run of MG_MARCH_LX planes, each unknown's centre
// plane with its y-z halo in static shared memory and its +-x taps in a
// queue of 2h+1 values in each thread's registers; rho and the aux arrays
// are read at the site with the plane's taps, a step ahead with
// MG_MARCH_AHEAD. pk_lap runs over the planes in box coordinates, so the
// march equals the per-site arithmetic bit for bit. The per-site kernel
// (mg_relax_kernel: one thread a site, z fastest, the 6h neighbour taps
// re-read through L1/L2) runs where the unknowns' centre planes do not fit
// a block's static shared memory and on regions of fewer than
// MG_MARCH_MIN_SITES sites (levels of 128^3 and below, a shell), where its
// blocks outnumber the march's and it ran faster on an H100 (PERF.md);
// the launch chooses from the region's shape (mg_marches), and
// multigrid/relax.py:mg_tile mirrors the rule (pk_mg_tile reports it).
// Periodic wrap by index arithmetic on every axis in both, so every level
// down to 2^3 runs (the TPU tier fell back to XLA below its blocking
// limits). Below ~64^3 the launch itself outlasts the work: the host sets
// the pace there. Built with -fmad=false, like every kernel of the port.
//
// The sharded levels (the _xpad, _ypad, _xypad entry points) replace the
// same body on the halo-input kernel StreamingStencil._build_xhalo
// (pystella_tpu/ops/pallas_stencil.py:789, call :840) and, through the
// interior and shell launches, on OverlapStreamingStencil.__call__ (:993),
// as RelaxationBase._pallas_level runs them on a sharded level
// (pystella_tpu/multigrid/relax.py:366-402): the unknowns are the window,
// padded along x and/or y by the neighbours' rows (PAD, pk_tap in
// pk_common.cuh) and read unwrapped there through pointers the host set to
// the region's origin, with the window's y extent Yw; rho, the restricted
// residual and the lattice aux arrays are blockwise, read at the output
// site, their pointers (and the outputs') set to the region's first x row
// of the full block. The interior launch reads the raw block as its
// x-padded window and the shell launches a (3h, Y, Z) slab per unknown;
// each writes its x rows of the full output block in place, so nothing is
// stitched (a shell is a run of h planes cut short). The taps and the
// update are the unpadded kernel's, so a padded (or split) launch equals
// the unsharded one on the whole lattice bit for bit; at PAD == 0 the index
// expressions are the unpadded ones. Bound: as
// above, plus the padded rows read once. The TPU's 8-row y alignment and
// its feasibility gate (relax.py:310-314) do not apply: any block runs.
#include "pk_common.cuh"

enum MgKind { MG_SMOOTH, MG_RESIDUAL, MG_TAU };

template <typename T>
struct MgArrays {
  const T* f[MG_NF];
  const T* rho[MG_NF];
  const T* aux[MG_NLAT > 0 ? MG_NLAT : 1];
  T* out[MG_NF];
};

template <typename T>
struct MgParams {
  double omega, lap_diag;
  T scal[MG_NSCAL > 0 ? MG_NSCAL : 1];
  PkLapWeights<T> w;
};

// A site's outputs of kind KIND from its values: mg_step, mg_resid, or for
// tau rho + mg_lhs.
template <typename T, int KIND>
__device__ __forceinline__ void mg_update(const MgSite<T>& s,
                                          T (&out)[MG_NF]) {
  if (KIND == MG_SMOOTH) {
    mg_step<T>(s, out);
  } else if (KIND == MG_RESIDUAL) {
    mg_resid<T>(s, out);
  } else {
    mg_lhs<T>(s, out);
#pragma unroll
    for (int i = 0; i < MG_NF; ++i) out[i] = s.rho[i] + out[i];
  }
}

// The per-site kernel: one thread a site. (X, Y, Z): the region computed;
// Yw: the window's y extent (Y unpadded).
template <typename T, int KIND, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
mg_relax_kernel(MgArrays<T> io, int X, int Y, int Z, MgParams<T> p, int Yw) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= Z || y >= Y) return;
  // blockwise arrays and outputs at the site, the window at its own extent
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const int Ys = PAD ? Yw : Y;
  const int64_t wsite = PAD ? ((int64_t)x * Ys + y) * Z + z : site;

  MgSite<T> s;
#pragma unroll
  for (int i = 0; i < MG_NF; ++i) {
    s.f[i] = io.f[i][wsite];
    s.lap[i] = pk_lap<PAD>(PkLoad<T>{io.f[i], Ys, Z}, s.f[i], x, y, z, X, Y,
                           Z, p.w);
    s.rho[i] = io.rho[i][site];
  }
#pragma unroll
  for (int j = 0; j < MG_NLAT; ++j) s.aux[j] = io.aux[j][site];
#pragma unroll
  for (int j = 0; j < MG_NSCAL; ++j) s.scal[j] = p.scal[j];
  s.omega = p.omega;
  s.lap_diag = p.lap_diag;

  T out[MG_NF];
  mg_update<T, KIND>(s, out);
#pragma unroll
  for (int i = 0; i < MG_NF; ++i) io.out[i][site] = out[i];
}

// x planes a run of the sweeps' march and whether its loads go a step
// ahead: the fastest variants of chip_smoke.py --phases march_variants on
// an H100; and the fewest sites of a region on which a launch marches: on
// a smaller one (a level of 128^3 or less, a one-plane shell) the per-site
// kernel ran faster there, its blocks outnumbering the march's by the run
// length
#ifndef MG_MARCH_LX
#define MG_MARCH_LX 32
#endif
#ifndef MG_MARCH_AHEAD
#define MG_MARCH_AHEAD 1
#endif
#ifndef MG_MARCH_MIN_SITES
#define MG_MARCH_MIN_SITES 4194304
#endif

template <typename T>
using MgTile = PkQueueTile<T, MG_NF, MG_MARCH_LX>;

// The values a site's update reads besides the taps: loaded with its plane.
template <typename T>
struct MgSiteLoads {
  T rho[MG_NF];
  T aux[MG_NLAT > 0 ? MG_NLAT : 1];
};

// The march (pk_queue_march over the MG_NF unknowns): block (z tile, y
// tile, run of MG_MARCH_LX planes) over the (X, Y, Z) region; f through the
// queues and centre planes, rho and the lattice aux arrays at the site with
// the plane's loads; the update is mg_relax_kernel's.
template <typename T, int KIND, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
mg_relax_march_kernel(MgArrays<T> io, int X, int Y, int Z, MgParams<T> p,
                      int Yw) {
  using Tl = MgTile<T>;
  const int xs = blockIdx.z * Tl::LX;
  const int z = blockIdx.x * Tl::TZ + threadIdx.x;
  const int y = blockIdx.y * Tl::TY + threadIdx.y;
  const bool valid = z < Z && y < Y;
  PkQueueSrc<T, MG_NF> src;
#pragma unroll
  for (int i = 0; i < MG_NF; ++i) src.p[i] = io.f[i];
  pk_queue_march<T, MG_NF, PAD, MG_MARCH_AHEAD>(
      src, X, Y, Z, PAD ? Yw : Y, xs, min(Tl::LX, X - xs),
      [&](int x) {
        MgSiteLoads<T> v{};
        if (!valid) return v;
        const int64_t site = ((int64_t)x * Y + y) * Z + z;
#pragma unroll
        for (int i = 0; i < MG_NF; ++i) v.rho[i] = io.rho[i][site];
#pragma unroll
        for (int j = 0; j < MG_NLAT; ++j) v.aux[j] = io.aux[j][site];
        return v;
      },
      [&](int x, const PkQueueLoad<T> (&col)[MG_NF],
          const MgSiteLoads<T>& v) {
        if (!valid) return;
        MgSite<T> s;
#pragma unroll
        for (int i = 0; i < MG_NF; ++i) {
          s.f[i] = col[i].q[PK_H];
          s.lap[i] = pk_queue_lap(col[i], p.w);
          s.rho[i] = v.rho[i];
        }
#pragma unroll
        for (int j = 0; j < MG_NLAT; ++j) s.aux[j] = v.aux[j];
#pragma unroll
        for (int j = 0; j < MG_NSCAL; ++j) s.scal[j] = p.scal[j];
        s.omega = p.omega;
        s.lap_diag = p.lap_diag;
        T out[MG_NF];
        mg_update<T, KIND>(s, out);
        const int64_t site = ((int64_t)x * Y + y) * Z + z;
#pragma unroll
        for (int i = 0; i < MG_NF; ++i) io.out[i][site] = out[i];
      });
}

// Whether a launch over an (X, Y, Z) region marches: the unknowns' centre
// planes fit a block's static shared memory and the region holds at least
// MG_MARCH_MIN_SITES sites.
template <typename T>
static bool mg_marches(int X, int Y, int Z) {
  return MgTile<T>::FITS && (int64_t)X * Y * Z >= MG_MARCH_MIN_SITES;
}

// f, rho, out: host arrays of MG_NF device pointers ((X, Y, Z) arrays); aux:
// MG_NLAT of them. params: omega, lap_diag, the Laplacian weights
// (pk_lap_weights), then the MG_NSCAL auxiliary scalars. Padded (PAD != 0):
// f points at the region's origin in windows of y extent Yw, the others at
// the region's first row of full blocks.
template <typename T, int KIND, int PAD>
static int mg_launch(const void* const* f, const void* const* rho,
                     const void* const* aux, void* const* out, int X, int Y,
                     int Z, const double* params, int Yw, void* stream) {
  MgArrays<T> io;
  for (int i = 0; i < MG_NF; ++i) {
    io.f[i] = (const T*)f[i];
    io.rho[i] = (const T*)rho[i];
    io.out[i] = (T*)out[i];
  }
  io.aux[0] = nullptr;
  for (int j = 0; j < MG_NLAT; ++j) io.aux[j] = (const T*)aux[j];
  MgParams<T> p;
  p.omega = params[0];
  p.lap_diag = params[1];
  p.w = pk_lap_weights<T>(params + 2);
  p.scal[0] = T(0);
  for (int j = 0; j < MG_NSCAL; ++j) p.scal[j] = T(params[2 + PK_NLAPW + j]);
  if constexpr (MgTile<T>::FITS) {
    if (mg_marches<T>(X, Y, Z)) {
      using Tl = MgTile<T>;
      mg_relax_march_kernel<T, KIND, PAD>
          <<<dim3((Z + Tl::TZ - 1) / Tl::TZ, (Y + Tl::TY - 1) / Tl::TY,
                  (X + Tl::LX - 1) / Tl::LX),
             dim3(Tl::TZ, Tl::TY, 1), 0, (cudaStream_t)stream>>>(io, X, Y, Z,
                                                                p, Yw);
      return (int)cudaGetLastError();
    }
  }
  mg_relax_kernel<T, KIND, PAD>
      <<<pk_grid(X, Y, Z), dim3(PK_BLOCK_Z, PK_BLOCK_Y, 1), 0,
         (cudaStream_t)stream>>>(io, X, Y, Z, p, Yw);
  return (int)cudaGetLastError();
}

// The march's tile for float (f64 = 0) or double (f64 = 1): out = {x planes
// a run, static shared memory a block in bytes (0 where the unknowns'
// centre planes do not fit, and every launch runs the per-site kernel), the
// fewest sites of a region on which a launch marches, 1 if the loads go a
// step ahead}. Returns 0.
extern "C" int pk_mg_tile(int f64, int* out) {
  out[0] = MgTile<float>::LX;
  out[1] = f64 ? (MgTile<double>::FITS ? MgTile<double>::SMEM : 0)
               : (MgTile<float>::FITS ? MgTile<float>::SMEM : 0);
  out[2] = MG_MARCH_MIN_SITES;
  out[3] = MG_MARCH_AHEAD;
  return 0;
}

#define MG_ARGS                                                             \
  const void *const *f, const void *const *rho, const void *const *aux,     \
      void *const *out, int X, int Y, int Z, const double *params
#define MG_ENTRY(name, T, KIND)                                             \
  extern "C" int name(MG_ARGS, void* stream) {                              \
    return mg_launch<T, KIND, 0>(f, rho, aux, out, X, Y, Z, params, Y,      \
                                 stream);                                   \
  }
// the sharded levels: windows padded along x, y or both (the interior and
// shell launches take the x-padded entry point)
#define MG_PAD_ENTRY(name, T, KIND, PAD)                                    \
  extern "C" int name(MG_ARGS, int Yw, void* stream) {                      \
    return mg_launch<T, KIND, PAD>(f, rho, aux, out, X, Y, Z, params, Yw,   \
                                   stream);                                 \
  }
#define MG_TYPED(kind, KIND, suffix, T)                                     \
  MG_ENTRY(mg_##kind##_##suffix, T, KIND)                                   \
  MG_PAD_ENTRY(mg_##kind##_##suffix##_xpad, T, KIND, PK_PAD_X)              \
  MG_PAD_ENTRY(mg_##kind##_##suffix##_ypad, T, KIND, PK_PAD_Y)              \
  MG_PAD_ENTRY(mg_##kind##_##suffix##_xypad, T, KIND, PK_PAD_X | PK_PAD_Y)
#define MG_ENTRIES(kind, KIND)                                              \
  MG_TYPED(kind, KIND, f32, float)                                          \
  MG_TYPED(kind, KIND, f64, double)

MG_ENTRIES(smooth, MG_SMOOTH)
MG_ENTRIES(residual, MG_RESIDUAL)
MG_ENTRIES(tau, MG_TAU)
