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
// unknown. Design: one thread per site, z fastest (coalesced centre loads
// and stores), the 6h neighbour taps re-read through L1/L2, periodic wrap by
// index arithmetic on every axis -- so every level down to 2^3 runs the
// same kernel (the TPU tier fell back to XLA below its blocking limits);
// a level smaller than a block launches partly idle blocks. Below ~64^3
// the launch itself outlasts the work: the host sets the pace there.
// Built with -fmad=false, like every kernel of the port.
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
// stitched. The taps and the update are the unpadded kernel's, so a padded
// (or split) launch equals the unsharded one on the whole lattice bit for
// bit; at PAD == 0 the index expressions are the unpadded ones. Bound: as
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

// (X, Y, Z): the region computed; Yw: the window's y extent (Y unpadded).
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
  if (KIND == MG_SMOOTH) {
    mg_step<T>(s, out);
  } else if (KIND == MG_RESIDUAL) {
    mg_resid<T>(s, out);
  } else {
    mg_lhs<T>(s, out);
#pragma unroll
    for (int i = 0; i < MG_NF; ++i) out[i] = s.rho[i] + out[i];
  }
#pragma unroll
  for (int i = 0; i < MG_NF; ++i) io.out[i][site] = out[i];
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
  mg_relax_kernel<T, KIND, PAD>
      <<<pk_grid(X, Y, Z), dim3(PK_BLOCK_Z, PK_BLOCK_Y, 1), 0,
         (cudaStream_t)stream>>>(io, X, Y, Z, p, Yw);
  return (int)cudaGetLastError();
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
