// K10: a whole Runge-Kutta chunk -- D consecutive fused 2N-storage stages of
// a ScalarSector system -- in one pass over device memory.
//
// K10 replaces the Pallas body FusedScalarStepper._chunk_body (+
// _compose_scalar_stage, _lap_at, _memo_taps) of pystella_tpu/ops/fused.py,
// built by _maybe_build_chunk and run by StreamingStencil / ResidentStencil
// (pystella_tpu/ops/pallas_stencil.py). The TPU kernel composes every
// post-stage array as a memoized view over a VMEM window whose halo is
// ceil(D/2)*h; the stage arithmetic at each element is that of the pair
// kernels it replaces, so D/2 pair launches and one chunk launch give the
// same bits.
//
// Bound: memory. A launch reads four arrays and writes four, as one pair
// launch does, for D stages instead of two: per stage the traffic falls
// from 4F to 8F/D component-arrays (2F at D = 4). The operations (~D times
// K2's, plus the halo's recompute) stay below the bytes.
//
// Design. The per-site template of K2/K3 (every tap re-read through L1/L2)
// cannot carry it: stage 4's Laplacian would need f3 at 6h+1 taps, each of
// them df2 and so lap f1 and lap f0 there -- about a thousand loads a site
// and component, against K3's forty. Here the intermediate stages live in
// shared memory:
//
// - One block computes one 3-D output tile (PK tile below: the first of a
//   few shapes whose box fits the 232,448 bytes a block may hold, chosen at
//   compile time from PK_F, PK_H, sizeof(T) and D). It loads f, dfdt, kf and
//   kdfdt of all components over the tile grown by R = (D/2)*h on each
//   side, periodically wrapped (any lattice shape runs, 16^3 included).
// - It then advances stage by stage in place, over regions that shrink:
//   after stage j, f and kf hold on the tile grown by R - (j/2)*h and dfdt
//   and kdfdt on the tile grown by R - ((j+1)/2)*h (integer division), so
//   stage D leaves all four on the tile itself. Each stage has two phases
//   with a barrier after each:
//     A. kf <- A*kf + dt*dfdt on the f region; then, on the velocity
//        region, kdf <- A*kdf + dt*((lap f - (2*hubble)*dfdt) - a^2*dV(f))
//        and dfdt <- dfdt + B*kdf (every value read at its own site, except
//        f, which phase A does not write);
//     B. f <- f + B*kf on the f region.
//   The last stage writes its four results to device memory instead.
// - Every expression is K3's, in K3's operation order; the Laplacian is
//   pk_lap over a shared-memory loader (its pk_wrap calls are no-ops in box
//   coordinates), so the accumulation order is lap_from_taps' by
//   construction, and with -fmad=false one K10 launch equals D/2 K3 launches
//   bit for bit.
// - bfloat16 carries (C = __nv_bfloat16, the _bf16 entry points): kf and
//   kdfdt are widened on load and rounded on store; in between, at the end
//   of every even stage but the last (where the pair sequence stores, and so
//   rounds, them), they are rounded in shared memory after f and dfdt have
//   been formed from the unrounded values -- never after an odd stage --,
//   which is _chunk_body's quantization.
//
// The x-march with per-stage plane rings, which would cut the halo's
// redundant loads and recompute to the y-z faces, is later perf work.
#include "pk_common.cuh"

// the most dynamic shared memory a block may use on sm_90
#define PK_SMEM_MAX 232448
// the depths instantiated below
#define PK_CHUNK_DEPTH 4

struct PkTile {
  int tx, ty, tz;
};

// Candidate output tiles, in order of preference (a smaller box loads and
// recomputes more of its halo per output site); ops/fused.py:_chunk_tile
// keeps the same list and rule.
constexpr PkTile pk_chunk_tiles[] = {{8, 8, 16}, {4, 8, 16}, {4, 4, 16},
                                     {4, 4, 8},  {2, 4, 8},  {2, 2, 8}};
constexpr int pk_num_chunk_tiles =
    sizeof(pk_chunk_tiles) / sizeof(pk_chunk_tiles[0]);

template <typename T, int D>
struct PkChunkTile {
  static constexpr int R = (D / 2) * PK_H;
  static constexpr long long bytes(PkTile t) {
    return 4LL * PK_F * (long long)sizeof(T) * (t.tx + 2 * R) *
           (t.ty + 2 * R) * (t.tz + 2 * R);
  }
  static constexpr int index() {
    for (int k = 0; k < pk_num_chunk_tiles; ++k)
      if (bytes(pk_chunk_tiles[k]) <= PK_SMEM_MAX) return k;
    return -1;
  }
  static constexpr bool feasible = index() >= 0;
  static constexpr PkTile tile =
      feasible ? pk_chunk_tiles[index() < 0 ? 0 : index()] : PkTile{1, 1, 1};
  static constexpr int TX = tile.tx, TY = tile.ty, TZ = tile.tz;
  static constexpr int SX = TX + 2 * R, SY = TY + 2 * R, SZ = TZ + 2 * R;
  static constexpr int S = SX * SY * SZ;  // sites of the box
};

// Threads a block (one block an SM): 1024 for float, whose 60 registers fit
// the 64 that allows (at 512^3, 10% faster than 512 threads), 512 for
// double (75 registers).
template <typename T>
constexpr int pk_chunk_threads() {
  return sizeof(T) == 4 ? 1024 : 512;
}

template <typename T, int D>
struct PkChunkParams {
  T dt;
  T a[D], hubble[D], A[D], B[D];
  PkLapWeights<T> w;
};

// One component of a box array in shared memory at box coordinates.
template <typename T, int SY, int SZ>
struct PkBoxLoad {
  const T* p;
  __device__ __forceinline__ T operator()(int x, int y, int z) const {
    return p[(x * SY + y) * SZ + z];
  }
};

// The box arrays: f, dfdt, kf, kdfdt, each PK_F components of S sites.
template <typename T>
struct PkBox {
  T* f;
  T* df;
  T* kf;
  T* kdf;
};

// Stage J (1-based) of D, on the box; see the file comment.
template <typename T, typename C, int D, int J>
__device__ __forceinline__ void pk_chunk_stage(const PkBox<T>& box,
                                               const PkChunkParams<T, D>& p,
                                               const PkArrays<T>& io,
                                               int x0, int y0, int z0, int X,
                                               int Y, int Z) {
  using Tile = PkChunkTile<T, D>;
  constexpr int R = Tile::R, S = Tile::S;
  constexpr int SX = Tile::SX, SY = Tile::SY, SZ = Tile::SZ;
  // margins of the f and the velocity region after this stage
  constexpr int mf = R - (J / 2) * PK_H;
  constexpr int md = R - ((J + 1) / 2) * PK_H;
  constexpr int dm = mf - md;  // 0 or h
  constexpr int nx = Tile::TX + 2 * mf, ny = Tile::TY + 2 * mf;
  constexpr int nz = Tile::TZ + 2 * mf;
  constexpr int o = R - mf;  // the region's first box index on each axis
  constexpr bool last = J == D;
  const T dt = p.dt, a = p.a[J - 1], A = p.A[J - 1], B = p.B[J - 1];
  const T two_hub = T(2) * p.hubble[J - 1];
  const T a2 = a * a;

  // phase A (the last stage: the whole stage, written to device memory)
  for (int s = threadIdx.x; s < nx * ny * nz; s += blockDim.x) {
    const int ix = s / (ny * nz), iy = (s / nz) % ny, iz = s % nz;
    const int lx = o + ix, ly = o + iy, lz = o + iz;
    const int l = (lx * SY + ly) * SZ + lz;
    const bool vel = ix >= dm && ix < nx - dm && iy >= dm && iy < ny - dm &&
                     iz >= dm && iz < nz - dm;
    T kf1[PK_F];
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      kf1[c] = A * box.kf[c * S + l] + dt * box.df[c * S + l];
      if (!last) box.kf[c * S + l] = kf1[c];
    }
    if (!vel) continue;
    T fc[PK_F], lap[PK_F], dv[PK_F];
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      fc[c] = box.f[c * S + l];
      lap[c] = pk_lap(PkBoxLoad<T, SY, SZ>{box.f + c * S}, fc[c], lx, ly, lz,
                      SX, SY, SZ, p.w);
    }
    pk_dvdf<T>(fc, a, p.hubble[J - 1], dv);
    if (last) {
      const int gx = x0 + ix, gy = y0 + iy, gz = z0 + iz;
      if (gx >= X || gy >= Y || gz >= Z) continue;
      const int64_t N = (int64_t)X * Y * Z;
      const int64_t g = ((int64_t)gx * Y + gy) * Z + gz;
#pragma unroll
      for (int c = 0; c < PK_F; ++c) {
        const T df0 = box.df[c * S + l];
        const T kdf1 = A * box.kdf[c * S + l]
                       + dt * ((lap[c] - two_hub * df0) - a2 * dv[c]);
        io.out[0][c * N + g] = fc[c] + B * kf1[c];
        io.out[1][c * N + g] = df0 + B * kdf1;
        pk_out_as<C>(io, 2)[c * N + g] = PkCarry<T, C>::store(kf1[c]);
        pk_out_as<C>(io, 3)[c * N + g] = PkCarry<T, C>::store(kdf1);
      }
    } else {
#pragma unroll
      for (int c = 0; c < PK_F; ++c) {
        const T df0 = box.df[c * S + l];
        const T kdf1 = A * box.kdf[c * S + l]
                       + dt * ((lap[c] - two_hub * df0) - a2 * dv[c]);
        box.kdf[c * S + l] = kdf1;
        box.df[c * S + l] = df0 + B * kdf1;
      }
    }
  }
  if constexpr (!last) {
    __syncthreads();
    // phase B; at an even stage the f and velocity regions coincide, and
    // the pair sequence would store (round) the carries here
    constexpr bool round = J % 2 == 0;
    for (int s = threadIdx.x; s < nx * ny * nz; s += blockDim.x) {
      const int ix = s / (ny * nz), iy = (s / nz) % ny, iz = s % nz;
      const int l = ((o + ix) * SY + (o + iy)) * SZ + (o + iz);
#pragma unroll
      for (int c = 0; c < PK_F; ++c) {
        const T k = box.kf[c * S + l];
        box.f[c * S + l] = box.f[c * S + l] + B * k;
        if (round) {
          box.kf[c * S + l] = pk_carry_round<T, C>(k);
          box.kdf[c * S + l] = pk_carry_round<T, C>(box.kdf[c * S + l]);
        }
      }
    }
    __syncthreads();
    pk_chunk_stage<T, C, D, J + 1>(box, p, io, x0, y0, z0, X, Y, Z);
  }
}

template <typename T, typename C, int D>
__global__ void __launch_bounds__(pk_chunk_threads<T>(), 1)
pk_fused_chunk_kernel(PkArrays<T> io, int X, int Y, int Z,
                      PkChunkParams<T, D> p) {
  using Tile = PkChunkTile<T, D>;
  constexpr int R = Tile::R, S = Tile::S, SY = Tile::SY, SZ = Tile::SZ;
  extern __shared__ __align__(16) unsigned char pk_chunk_smem[];
  T* const base = reinterpret_cast<T*>(pk_chunk_smem);
  const PkBox<T> box{base, base + PK_F * S, base + 2 * PK_F * S,
                     base + 3 * PK_F * S};

  // the tile's origin on the lattice (tiles z fastest)
  const int ntz = (Z + Tile::TZ - 1) / Tile::TZ;
  const int nty = (Y + Tile::TY - 1) / Tile::TY;
  const int64_t b = blockIdx.x;
  const int x0 = (int)(b / ((int64_t)nty * ntz)) * Tile::TX;
  const int y0 = (int)((b / ntz) % nty) * Tile::TY;
  const int z0 = (int)(b % ntz) * Tile::TZ;
  const int64_t N = (int64_t)X * Y * Z;
  const C* __restrict__ kf = pk_in_as<C>(io, 2);
  const C* __restrict__ kdf = pk_in_as<C>(io, 3);

  // the box: every array over the tile grown by R, periodically wrapped
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int lx = s / (SY * SZ), ly = (s / SZ) % SY, lz = s % SZ;
    const int64_t g = ((int64_t)pk_wrap(x0 - R + lx, X) * Y
                       + pk_wrap(y0 - R + ly, Y)) * Z
                      + pk_wrap(z0 - R + lz, Z);
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      box.f[c * S + s] = io.in[0][c * N + g];
      box.df[c * S + s] = io.in[1][c * N + g];
      box.kf[c * S + s] = PkCarry<T, C>::load(kf[c * N + g]);
      box.kdf[c * S + s] = PkCarry<T, C>::load(kdf[c * N + g]);
    }
  }
  __syncthreads();
  pk_chunk_stage<T, C, D, 1>(box, p, io, x0, y0, z0, X, Y, Z);
}

// ins / outs: host arrays of the 4 device pointers f, dfdt, kf, kdfdt.
// params: dt, then for each stage i = 1..D a_i, hubble_i, A_i, B_i, then the
// Laplacian weights (pk_lap_weights). A model whose box fits no tile has no
// kernel: the entry point returns cudaErrorInvalidConfiguration (the
// steppers check pk_fused_chunk_tile first and run pairs instead).
template <typename T, typename C, int D>
static int pk_launch_chunk(const void* const* ins, void* const* outs, int X,
                           int Y, int Z, const double* params, void* stream) {
  using Tile = PkChunkTile<T, D>;
  if constexpr (!Tile::feasible) {
    return (int)cudaErrorInvalidConfiguration;
  } else {
    static_assert(Tile::bytes(Tile::tile) <= PK_SMEM_MAX,
                  "the chunk tile's box exceeds a block's shared memory");
    PkChunkParams<T, D> p;
    p.dt = T(params[0]);
    for (int i = 0; i < D; ++i) {
      p.a[i] = T(params[1 + 4 * i]);
      p.hubble[i] = T(params[2 + 4 * i]);
      p.A[i] = T(params[3 + 4 * i]);
      p.B[i] = T(params[4 + 4 * i]);
    }
    p.w = pk_lap_weights<T>(params + 1 + 4 * D);
    const int smem = (int)Tile::bytes(Tile::tile);
    cudaError_t rc = cudaFuncSetAttribute(
        pk_fused_chunk_kernel<T, C, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    const long long ntiles = (long long)((X + Tile::TX - 1) / Tile::TX) *
                             ((Y + Tile::TY - 1) / Tile::TY) *
                             ((Z + Tile::TZ - 1) / Tile::TZ);
    if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    pk_fused_chunk_kernel<T, C, D>
        <<<(unsigned)ntiles, pk_chunk_threads<T>(), smem,
           (cudaStream_t)stream>>>(
            pk_arrays<T>(ins, outs, 4), X, Y, Z, p);
    return (int)cudaGetLastError();
  }
}

// The tile the depth-`depth` kernel of the float (f64 = 0) or double
// (f64 = 1) working type uses: out = {tx, ty, tz, shared-memory bytes per
// block}. Returns 0, or -1 when no kernel of that depth is instantiated or
// no tile fits.
extern "C" int pk_fused_chunk_tile(int depth, int f64, int* out) {
  if (depth != PK_CHUNK_DEPTH) return -1;
  using T32 = PkChunkTile<float, PK_CHUNK_DEPTH>;
  using T64 = PkChunkTile<double, PK_CHUNK_DEPTH>;
  const bool ok = f64 ? T64::feasible : T32::feasible;
  if (!ok) return -1;
  const PkTile t = f64 ? T64::tile : T32::tile;
  out[0] = t.tx;
  out[1] = t.ty;
  out[2] = t.tz;
  out[3] = (int)(f64 ? T64::bytes(t) : T32::bytes(t));
  return 0;
}

#define PK_CHUNK_ARGS                                                       \
  const void *const *ins, void *const *outs, int X, int Y, int Z,           \
      const double *params, void *stream

// One entry point per (T, C) at depth PK_CHUNK_DEPTH; the _bf16 ones store
// the carries kf, kdfdt in bfloat16.
#define PK_CHUNK_ENTRY(name, T, C)                                          \
  extern "C" int name(PK_CHUNK_ARGS) {                                      \
    return pk_launch_chunk<T, C, PK_CHUNK_DEPTH>(ins, outs, X, Y, Z, params,\
                                                 stream);                   \
  }

PK_CHUNK_ENTRY(pk_fused_chunk_f32, float, float)
PK_CHUNK_ENTRY(pk_fused_chunk_f64, double, double)
PK_CHUNK_ENTRY(pk_fused_chunk_f32_bf16, float, __nv_bfloat16)
PK_CHUNK_ENTRY(pk_fused_chunk_f64_bf16, double, __nv_bfloat16)
