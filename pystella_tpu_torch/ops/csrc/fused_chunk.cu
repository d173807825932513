// K10: a whole Runge-Kutta chunk -- four consecutive fused 2N-storage stages
// of a ScalarSector system -- in one pass over device memory.
//
// K10 replaces the Pallas body FusedScalarStepper._chunk_body (+
// _compose_scalar_stage, _lap_at, _memo_taps) of pystella_tpu/ops/fused.py,
// built by _maybe_build_chunk and run by StreamingStencil._build
// (pystella_tpu/ops/pallas_stencil.py:709) through its x ring of planes
// with a window halo of (D/2)*h, or by ResidentStencil on a small lattice.
// The stage arithmetic at each element is that of the pair kernel K3
// (fused_pair.cu) in K3's operation order, so one chunk launch and two K3
// launches give the same bits.
//
// Bound: memory. A launch reads four arrays and writes four, as one pair
// launch does, for four stages instead of two: per stage the traffic falls
// from 4F to 2F component-arrays. The operations (about twice K3's, plus
// the halo's recompute) stay below the bytes.
//
// Design: the TPU builder's x ring, carried to a block in two levels, as
// the pairs' march (pk_march, pk_common.cuh) carries it in one. Stages 3
// and 4 (level 2) tap f2 and f3 within h of an output site, and those come
// from stages 1 and 2 (level 1) at every tap. A block owns a y-z tile (the
// first rung of pk_chunk_rungs whose planes fit the most dynamic shared
// memory a block may use) and walks it along x over a run of LX planes.
// Its shared memory holds
//  - level 0, per field, f and f1 = f + B1*(A1*kf + dt*dfdt): a ring of
//    2h+1 planes of the tile grown by h in y and z (the +-x taps of a
//    level-1 site) and the centre plane grown by 2h (its y and z taps);
//    f1 is composed once an element as it is loaded, in PkMarchInputs::
//    composed's expression, the value K3's first stage stores;
//  - level 1, per field, f2 and f3 = f2 + B3*(A3*kf2 + dt*dfdt2): a ring of
//    2h+1 planes of the tile grown by h;
//  - a delay ring of h+1 planes of the tile itself holding dfdt2, kf2 and
//    kdfdt2, which level 2 reads h planes after level 1 made them.
// A level keeps the 2F values a site's Laplacians tap together, a record
// (f and f1 of every field; f2 and f3), so one vector load a tap serves
// all 2F Laplacians of the site (pk_rec_laps), each still summed in
// lap_from_taps' order.
// Step i of a run brings level-0 plane xs+i into the ring and plane
// xs-h+i's halo frame into the centre plane, with every load of the step
// in flight together; after a barrier it runs K3's two stages at plane
// xs-h+i on every site of the tile grown by h (level 1; wrapped duplicate
// sites compute the same values and are never written), and after a
// second barrier, from step 2h on, K3's two stages at plane xs-2h+i on the
// tile (level 2), written to device memory. So a run takes 2h steps of
// prologue, and level 0 reads planes xs-2h .. xs+LX-1+2h. Periodic wrap is
// resolved where a plane, row or column is loaded, so every lattice shape
// runs, 2^3 included; a tile hanging past Y or Z computes wrapped values
// and writes nothing there. With -fmad=false one K10 launch equals two K3
// launches bit for bit.
//
// On an H100 (chip_smoke.py --phases march_variants, 512^3 f32) runs of
// 64 planes were the fastest of 16-64, and a first tile of 8 rows faster
// than one of 16 (two blocks an SM against one).
//
// bfloat16 carries (C = __nv_bfloat16, the _bf16 entry points): kf and
// kdfdt are widened on load and rounded on store; level 1 rounds kf2 and
// kdfdt2 after f2 and dfdt2 have been formed from the unrounded values and
// before f3 is composed -- where the pair sequence stores, and so rounds,
// them; stage 1's carries are never rounded -- which is _chunk_body's
// quantization.
#include "pk_common.cuh"

// x planes a run of the chunk march, and the rows of its first y-z tile:
// the fastest variant of chip_smoke.py --phases march_variants on an H100
#ifndef PK_CHUNK_LX
#define PK_CHUNK_LX 64
#endif
#ifndef PK_CHUNK_ROWS
#define PK_CHUNK_ROWS 8
#endif
// the depth instantiated below: two levels of two stages
#define PK_CHUNK_DEPTH 4

struct PkRung {
  int ty, tz;
};

// The march's y-z tiles (rows, columns), in order of preference (a smaller
// tile loads and recomputes more of its halo per output site);
// ops/fused.py:chunk_tile keeps the same ladder and rule.
constexpr PkRung pk_chunk_rungs[] = {{PK_CHUNK_ROWS, 32}, {4, 32}, {8, 16},
                                     {4, 16}, {2, 16}, {2, 8}, {1, 8},
                                     {2, 4}};
constexpr int pk_num_chunk_rungs =
    sizeof(pk_chunk_rungs) / sizeof(pk_chunk_rungs[0]);

// The geometry of the march for working type T (see the file comment).
template <typename T>
struct PkChunkMarch {
  static constexpr int H = PK_H, NS = 2 * PK_H + 1, ND = PK_H + 1;
  // level 0: 2F arrays of a ring and a centre plane; level 1: 2F arrays of
  // a ring; the delay ring: 3F arrays
  static constexpr long long bytes(PkRung r) {
    const long long g1 = (long long)(r.ty + 2 * H) * (r.tz + 2 * H);
    const long long g2 = (long long)(r.ty + 4 * H) * (r.tz + 4 * H);
    return (long long)sizeof(T) * PK_F
           * (2 * (2 * NS * g1 + g2) + 3LL * ND * r.ty * r.tz);
  }
  static constexpr int index() {
    for (int k = 0; k < pk_num_chunk_rungs; ++k)
      if (bytes(pk_chunk_rungs[k]) <= PK_MARCH_SMEM) return k;
    return -1;
  }
  static constexpr bool feasible = index() >= 0;
  static constexpr PkRung rung = pk_chunk_rungs[feasible ? index() : 0];
  static constexpr int LX = PK_CHUNK_LX, TY = rung.ty, TZ = rung.tz;
  static constexpr int TILE = TY * TZ;
  static constexpr int THREADS = TILE < 128 ? 128 : TILE;
  // level 1's plane: the tile grown by h; level 0's centre: grown by 2h
  static constexpr int S1Y = TY + 2 * H, S1Z = TZ + 2 * H, G1 = S1Y * S1Z;
  static constexpr int S2Y = TY + 4 * H, S2Z = TZ + 4 * H, G2 = S2Y * S2Z;
  static constexpr int FRAME = G2 - G1;  // the centre plane's outer frame
  // A site of a level keeps its 2F tapped values together, a record: f of
  // every field, then f1 (level 0), or f2, then f3 (level 1). Element
  // offsets in shared memory: level 0's ring (NS planes of G1 records),
  // then its centre plane (G2 records); level 1's ring at L1; the delay
  // ring at DL, array d (dfdt2 at c, kf2 at F + c, kdfdt2 at 2F + c) at
  // DL + d * AD
  static constexpr int R = 2 * PK_F, CTR = NS * G1 * R;
  static constexpr int L1 = CTR + G2 * R, DL = L1 + NS * G1 * R;
  static constexpr int AD = ND * TILE;
  static constexpr int SMEM = (int)bytes(rung);
  // elements of a ring plane and of the frame a thread loads
  static constexpr int NR = (G1 + THREADS - 1) / THREADS;
  static constexpr int NF = (FRAME + THREADS - 1) / THREADS;
};

template <typename T>
struct PkChunkParams {
  T dt;
  T a[PK_CHUNK_DEPTH], hubble[PK_CHUNK_DEPTH], A[PK_CHUNK_DEPTH],
      B[PK_CHUNK_DEPTH];
  PkLapWeights<T> w;
};

// A record of N values of T at p, read or written with the widest vector
// accesses its alignment allows (a record of 2F values starts at a
// multiple of its own size: 16 bytes, or 8 for an odd F in float).
template <int N, typename T>
__device__ __forceinline__ void pk_rec_load(const T* p, T (&v)[N]) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 u = reinterpret_cast<const float4*>(p)[j];
      v[4 * j] = u.x;
      v[4 * j + 1] = u.y;
      v[4 * j + 2] = u.z;
      v[4 * j + 3] = u.w;
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float2 u = reinterpret_cast<const float2*>(p)[j];
      v[2 * j] = u.x;
      v[2 * j + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const double2 u = reinterpret_cast<const double2*>(p)[j];
      v[2 * j] = u.x;
      v[2 * j + 1] = u.y;
    }
  }
}

template <int N, typename T>
__device__ __forceinline__ void pk_rec_store(T* p, const T (&v)[N]) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      reinterpret_cast<float4*>(p)[j] =
          float4{v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]};
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j)
      reinterpret_cast<float2*>(p)[j] = float2{v[2 * j], v[2 * j + 1]};
  } else {
#pragma unroll
    for (int j = 0; j < N / 2; ++j)
      reinterpret_cast<double2*>(p)[j] = double2{v[2 * j], v[2 * j + 1]};
  }
}

// The Laplacians of every value of a record at once (out[a] for value a,
// around centre values ctr), each in lap_from_taps' order (pk_lap's):
// w0 * centre, then for s = 1..h the x, the y and the z pair.
// rec(x, y, z) points at the record at box coordinates (x, y, z), the
// site at (h, y, z).
template <int N, typename T, typename Rec>
__device__ __forceinline__ void pk_rec_laps(const Rec& rec, const T (&ctr)[N],
                                            int y, int z,
                                            const PkLapWeights<T>& w,
                                            T (&out)[N]) {
#pragma unroll
  for (int a = 0; a < N; ++a) out[a] = w.w0 * ctr[a];
#pragma unroll
  for (int s = 1; s <= PK_H; ++s) {
    T u[N], v[N];
    pk_rec_load(rec(PK_H + s, y, z), u);
    pk_rec_load(rec(PK_H - s, y, z), v);
#pragma unroll
    for (int a = 0; a < N; ++a) out[a] = out[a] + w.wx[s - 1] * (u[a] + v[a]);
    pk_rec_load(rec(PK_H, y + s, z), u);
    pk_rec_load(rec(PK_H, y - s, z), v);
#pragma unroll
    for (int a = 0; a < N; ++a) out[a] = out[a] + w.wy[s - 1] * (u[a] + v[a]);
    pk_rec_load(rec(PK_H, y, z + s), u);
    pk_rec_load(rec(PK_H, y, z - s), v);
#pragma unroll
    for (int a = 0; a < N; ++a) out[a] = out[a] + w.wz[s - 1] * (u[a] + v[a]);
  }
}

// Level 0 around a level-1 site, in box coordinates: x = h is the centre
// plane (any y, z of the plane grown by 2h), another x the ring plane
// x - h away at the site's own (y, z).
template <typename M, typename T>
struct PkChunkRec0 {
  const T* centre;
  const T* ring;  // slot 0 at the site
  int s0;         // the slot of box x = 0
  __device__ __forceinline__ const T* operator()(int x, int y, int z) const {
    if (x == PK_H) return centre + (y * M::S2Z + z) * M::R;
    int s = s0 + x;
    if (s >= M::NS) s -= M::NS;
    return ring + s * M::G1 * M::R;
  }
};

// Level 1 around a tile site, in box coordinates: planes of the tile grown
// by h, box x in ring slot s0 + x (mod 2h+1).
template <typename M, typename T>
struct PkChunkRec1 {
  const T* ring;
  int s0;
  __device__ __forceinline__ const T* operator()(int x, int y, int z) const {
    int s = s0 + x;
    if (s >= M::NS) s -= M::NS;
    return ring + (s * M::G1 + y * M::S1Z + z) * M::R;
  }
};

// K3's two stages at a site (pk_pair_scalar's arithmetic and order),
// stages J and J + 1 of the chunk (0-based), in place: f, df, kf, kdf
// enter as stage J's inputs and leave as stage J + 2's; laps(ctr, out)
// gives the Laplacians of the record around the site, whose values there
// are f and the stage-J field f1.
template <int J, typename T, typename Laps>
__device__ __forceinline__ void pk_chunk_pair(const PkChunkParams<T>& p,
                                              Laps&& laps, T (&f)[PK_F],
                                              T (&df)[PK_F], T (&kf)[PK_F],
                                              T (&kdf)[PK_F]) {
  T f1[PK_F], dv[PK_F], ctr[2 * PK_F], l[2 * PK_F];
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    kf[c] = p.A[J] * kf[c] + p.dt * df[c];
    f1[c] = f[c] + p.B[J] * kf[c];
    ctr[c] = f[c];
    ctr[PK_F + c] = f1[c];
  }
  laps(ctr, l);
  pk_dvdf<T>(f, p.a[J], p.hubble[J], dv);
  {
    const T two_hub = T(2) * p.hubble[J];
    const T a2 = p.a[J] * p.a[J];
#pragma unroll
    for (int c = 0; c < PK_F; ++c) {
      kdf[c] = p.A[J] * kdf[c]
               + p.dt * ((l[c] - two_hub * df[c]) - a2 * dv[c]);
      df[c] = df[c] + p.B[J] * kdf[c];
    }
  }
  pk_dvdf<T>(f1, p.a[J + 1], p.hubble[J + 1], dv);
  const T two_hub = T(2) * p.hubble[J + 1];
  const T a2 = p.a[J + 1] * p.a[J + 1];
#pragma unroll
  for (int c = 0; c < PK_F; ++c) {
    kf[c] = p.A[J + 1] * kf[c] + p.dt * df[c];
    kdf[c] = p.A[J + 1] * kdf[c]
             + p.dt * ((l[PK_F + c] - two_hub * df[c]) - a2 * dv[c]);
    f[c] = f1[c] + p.B[J + 1] * kf[c];
    df[c] = df[c] + p.B[J + 1] * kdf[c];
  }
}

// The site values level 1 reads from device memory: dfdt, kf, kdfdt
// (widened).
template <typename T>
struct PkChunkSite {
  T df[PK_F], kf[PK_F], kdf[PK_F];
};

template <typename T, typename C>
__global__ void __launch_bounds__(PkChunkMarch<T>::THREADS, 1)
pk_fused_chunk_march_kernel(PkArrays<T> io, int X, int Y, int Z,
                            PkChunkParams<T> p) {
  using M = PkChunkMarch<T>;
  constexpr int H = M::H, NS = M::NS, F = PK_F;
  extern __shared__ __align__(16) unsigned char pk_chunk_smem[];
  T* const sm = reinterpret_cast<T*>(pk_chunk_smem);
  const int tid = threadIdx.x;
  const int z0 = blockIdx.x * M::TZ, y0 = blockIdx.y * M::TY;
  const int xs = blockIdx.z * M::LX;
  const int nx = min(M::LX, X - xs);
  const int64_t N = (int64_t)X * Y * Z;
  const C* const kfp = pk_in_as<C>(io, 2);
  const C* const kdfp = pk_in_as<C>(io, 3);
  const PkMarchInputs<T, C, false> in{
      {io.in[0], nullptr}, {io.in[1], nullptr}, {kfp, nullptr},
      {nullptr, nullptr}, p.B[0], p.A[0], p.dt, T(0), T(0)};
  auto at = [&](int x, int y, int z) {
    return ((int64_t)pk_wrap(x, X) * Y + pk_wrap(y, Y)) * Z + pk_wrap(z, Z);
  };
  // f and f1 of every field at lattice point (x, y, z), wrapped
  auto gather = [&](int x, int y, int z, T (&v)[2 * F]) {
    const int64_t w = at(x, y, z);
#pragma unroll
    for (int c = 0; c < F; ++c) {
      v[c] = io.in[0][c * N + w];
      v[F + c] = in.composed(0, c * N + w, v[c]);
    }
  };
  auto put = [&](const T (&v)[M::R], int pos) {
    pk_rec_store(sm + pos * M::R, v);
  };
  auto site = [&](int x, int k) {
    PkChunkSite<T> s;
    const int64_t w = at(x, y0 - H + k / M::S1Z, z0 - H + k % M::S1Z);
#pragma unroll
    for (int c = 0; c < F; ++c) {
      s.df[c] = io.in[1][c * N + w];
      s.kf[c] = PkCarry<T, C>::load(kfp[c * N + w]);
      s.kdf[c] = PkCarry<T, C>::load(kdfp[c * N + w]);
    }
    return s;
  };
  // the centre plane's outer frame, element e: h rows above and below,
  // then h columns on either side of each row of the tile grown by h
  auto frame_at = [](int e, int& yy, int& zz) {
    if (e < 2 * H * M::S2Z) {
      yy = e / M::S2Z;
      zz = e % M::S2Z;
      if (yy >= H) yy += M::S1Y;
    } else {
      const int r = e - 2 * H * M::S2Z;
      yy = H + r / (2 * H);
      zz = r % (2 * H);
      if (zz >= H) zz += M::S1Z;
    }
  };

  // the level-0 ring: planes xs - 2h .. xs - 1 in slots 0 .. 2h - 1
  for (int q = 0; q < 2 * H; ++q) {
    for (int k = tid; k < M::G1; k += M::THREADS) {
      T v[2 * F];
      gather(xs - 2 * H + q, y0 - H + k / M::S1Z, z0 - H + k % M::S1Z, v);
      put(v, q * M::G1 + k);
    }
  }
  for (int i = 0; i < nx + 2 * H; ++i) {
    const int p1 = xs - H + i;  // level 1's plane
    // level-0 plane p1 + h for the ring, the frame of plane p1, the own
    // values of the thread's level-1 sites: all loads in flight together
    T ring[M::NR][2 * F], edge[M::NF][2 * F];
#pragma unroll
    for (int r = 0; r < M::NR; ++r) {
      const int k = tid + r * M::THREADS;
      if (k < M::G1)
        gather(p1 + H, y0 - H + k / M::S1Z, z0 - H + k % M::S1Z, ring[r]);
    }
#pragma unroll
    for (int r = 0; r < M::NF; ++r) {
      const int e = tid + r * M::THREADS;
      if (e < M::FRAME) {
        int yy, zz;
        frame_at(e, yy, zz);
        gather(p1, y0 - 2 * H + yy, z0 - 2 * H + zz, edge[r]);
      }
    }
    PkChunkSite<T> vals[M::NR];
#pragma unroll
    for (int r = 0; r < M::NR; ++r) {
      const int k = tid + r * M::THREADS;
      if (k < M::G1) vals[r] = site(p1, k);
    }
    {
      // plane p1 from the ring into the centre plane
      const int src = ((i + H) % NS) * M::G1;
      for (int k = tid; k < M::G1; k += M::THREADS) {
        T v[M::R];
        pk_rec_load(sm + (src + k) * M::R, v);
        put(v, NS * M::G1 + (k / M::S1Z + H) * M::S2Z + k % M::S1Z + H);
      }
    }
#pragma unroll
    for (int r = 0; r < M::NR; ++r) {
      const int k = tid + r * M::THREADS;
      if (k < M::G1) put(ring[r], ((i + 2 * H) % NS) * M::G1 + k);
    }
#pragma unroll
    for (int r = 0; r < M::NF; ++r) {
      const int e = tid + r * M::THREADS;
      if (e < M::FRAME) {
        int yy, zz;
        frame_at(e, yy, zz);
        put(edge[r], NS * M::G1 + yy * M::S2Z + zz);
      }
    }
    __syncthreads();

    // level 1: stages 1 and 2 at plane p1 on the tile grown by h
#pragma unroll
    for (int r = 0; r < M::NR; ++r) {
      const int k = tid + r * M::THREADS;
      if (k >= M::G1) break;
      PkChunkSite<T> s = vals[r];
      const int yy = k / M::S1Z, zz = k % M::S1Z;
      T v[M::R], f[F];
      pk_rec_load(sm + M::CTR + ((yy + H) * M::S2Z + zz + H) * M::R, v);
#pragma unroll
      for (int c = 0; c < F; ++c) f[c] = v[c];
      pk_chunk_pair<0>(p, [&](const T (&ctr)[M::R], T (&l)[M::R]) {
        pk_rec_laps(PkChunkRec0<M, T>{sm + M::CTR, sm + k * M::R, i % NS},
                    ctr, yy + H, zz + H, p.w, l);
      }, f, s.df, s.kf, s.kdf);
#pragma unroll
      for (int c = 0; c < F; ++c) {
        // the carries as the pair sequence stores them, then f3 as K3's
        // second launch composes it
        s.kf[c] = pk_carry_round<T, C>(s.kf[c]);
        s.kdf[c] = pk_carry_round<T, C>(s.kdf[c]);
        v[c] = f[c];
        v[F + c] = f[c] + p.B[2] * (p.A[2] * s.kf[c] + p.dt * s.df[c]);
      }
      pk_rec_store(sm + M::L1 + ((i % NS) * M::G1 + k) * M::R, v);
      const int ty = yy - H, tz = zz - H;
      if (ty >= 0 && ty < M::TY && tz >= 0 && tz < M::TZ) {
        const int d = M::DL + (i % M::ND) * M::TILE + ty * M::TZ + tz;
#pragma unroll
        for (int c = 0; c < F; ++c) {
          sm[d + c * M::AD] = s.df[c];
          sm[d + (F + c) * M::AD] = s.kf[c];
          sm[d + (2 * F + c) * M::AD] = s.kdf[c];
        }
      }
    }
    __syncthreads();

    // level 2: stages 3 and 4 at plane x on the tile, to device memory
    const int x = p1 - H;
    if (i < 2 * H || tid >= M::TILE) continue;
    const int ty = tid / M::TZ, tz = tid % M::TZ;
    const int y = y0 + ty, z = z0 + tz;
    if (y >= Y || z >= Z) continue;
    const int s0 = (i + 1) % NS;
    const int k1 = (ty + H) * M::S1Z + tz + H;
    const int d = M::DL + ((i + 1) % M::ND) * M::TILE + tid;
    const PkChunkRec1<M, T> rec{sm + M::L1, s0};
    T f[F], df[F], kf[F], kdf[F];
    {
      T v[M::R];
      pk_rec_load(rec(H, ty + H, tz + H), v);
#pragma unroll
      for (int c = 0; c < F; ++c) {
        f[c] = v[c];
        df[c] = sm[d + c * M::AD];
        kf[c] = sm[d + (F + c) * M::AD];
        kdf[c] = sm[d + (2 * F + c) * M::AD];
      }
    }
    pk_chunk_pair<2>(p, [&](const T (&ctr)[M::R], T (&l)[M::R]) {
      pk_rec_laps(rec, ctr, ty + H, tz + H, p.w, l);
    }, f, df, kf, kdf);
    const int64_t g = ((int64_t)x * Y + y) * Z + z;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      io.out[0][c * N + g] = f[c];
      io.out[1][c * N + g] = df[c];
      pk_out_as<C>(io, 2)[c * N + g] = PkCarry<T, C>::store(kf[c]);
      pk_out_as<C>(io, 3)[c * N + g] = PkCarry<T, C>::store(kdf[c]);
    }
  }
}

// ins / outs: host arrays of the 4 device pointers f, dfdt, kf, kdfdt.
// params: dt, then for each stage i = 1..4 a_i, hubble_i, A_i, B_i, then the
// Laplacian weights (pk_lap_weights). A model whose planes fit no tile has
// no kernel: the entry point returns cudaErrorInvalidConfiguration (the
// steppers check pk_fused_chunk_tile first and run pairs instead).
template <typename T, typename C>
static int pk_launch_chunk(const void* const* ins, void* const* outs, int X,
                           int Y, int Z, const double* params, void* stream) {
  using M = PkChunkMarch<T>;
  if constexpr (!M::feasible) {
    return (int)cudaErrorInvalidConfiguration;
  } else {
    static_assert(M::SMEM <= PK_MARCH_SMEM,
                  "the chunk march exceeds a block's shared memory");
    PkChunkParams<T> p;
    p.dt = T(params[0]);
    for (int i = 0; i < PK_CHUNK_DEPTH; ++i) {
      p.a[i] = T(params[1 + 4 * i]);
      p.hubble[i] = T(params[2 + 4 * i]);
      p.A[i] = T(params[3 + 4 * i]);
      p.B[i] = T(params[4 + 4 * i]);
    }
    p.w = pk_lap_weights<T>(params + 1 + 4 * PK_CHUNK_DEPTH);
    const cudaError_t rc = cudaFuncSetAttribute(
        pk_fused_chunk_march_kernel<T, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, M::SMEM);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 grid((Z + M::TZ - 1) / M::TZ, (Y + M::TY - 1) / M::TY,
                    (X + M::LX - 1) / M::LX);
    pk_fused_chunk_march_kernel<T, C>
        <<<grid, M::THREADS, M::SMEM, (cudaStream_t)stream>>>(
            pk_arrays<T>(ins, outs, 4), X, Y, Z, p);
    return (int)cudaGetLastError();
  }
}

// The march of the depth-`depth` kernel of the float (f64 = 0) or double
// (f64 = 1) working type: out = {x planes a run, tile rows (y), tile
// columns (z), dynamic shared memory a block in bytes}. Returns 0, or -1
// when no kernel of that depth is instantiated or no tile fits.
extern "C" int pk_fused_chunk_tile(int depth, int f64, int* out) {
  if (depth != PK_CHUNK_DEPTH) return -1;
  using M32 = PkChunkMarch<float>;
  using M64 = PkChunkMarch<double>;
  if (!(f64 ? M64::feasible : M32::feasible)) return -1;
  out[0] = PK_CHUNK_LX;
  out[1] = f64 ? M64::TY : M32::TY;
  out[2] = f64 ? M64::TZ : M32::TZ;
  out[3] = f64 ? M64::SMEM : M32::SMEM;
  return 0;
}

#define PK_CHUNK_ARGS                                                       \
  const void *const *ins, void *const *outs, int X, int Y, int Z,           \
      const double *params, void *stream

// One entry point per (T, C); the _bf16 ones store the carries kf, kdfdt
// in bfloat16.
#define PK_CHUNK_ENTRY(name, T, C)                                          \
  extern "C" int name(PK_CHUNK_ARGS) {                                      \
    return pk_launch_chunk<T, C>(ins, outs, X, Y, Z, params, stream);       \
  }

PK_CHUNK_ENTRY(pk_fused_chunk_f32, float, float)
PK_CHUNK_ENTRY(pk_fused_chunk_f64, double, double)
PK_CHUNK_ENTRY(pk_fused_chunk_f32_bf16, float, __nv_bfloat16)
PK_CHUNK_ENTRY(pk_fused_chunk_f64_bf16, double, __nv_bfloat16)
