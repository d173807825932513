// K13 `bincount` and K14 `spectra_bin`: deterministic binning of lattice
// values into histograms, and the finish launch that reduces their partials.
//
// The JAX package has no Pallas kernel here: it bins with jnp.bincount in
// chunks of at most 2^22 sites and sums the chunk partials on the host
// (pystella_tpu/ops/histogram.py:64-183, and PowerSpectra.bin_power,
// pystella_tpu/fourier/spectra.py:159). PyTorch's CUDA bincount scatters
// with float atomics, whose sums change from run to run, so the port bins
// with these kernels instead.
//
// Units. A unit is one x-plane times a run of `ry` y-rows, z whole: a
// contiguous run of ry * Z elements of a C-ordered (outer, X, Y, Z) array
// (or of a block of one). A unit's global index is x * nyr + y / ry, so a
// block boundary of any mesh whose block y-extent is a multiple of ry falls
// between units. One CUDA block bins one (unit, outer slice) and writes that
// unit's whole row of partials (int32 counts or float64 sums, every bin);
// a launch on a block of a sharded lattice writes only its own units, at
// their global rows. The finish launch then sums every unit's row in one
// fixed order, so a sharded lattice gives the single-device result bit for
// bit.
//
// Bound: bytes. K13 reads its int32 bins (and weights) once; K14 reads the
// complex half spectrum once and derives |k|, the r2c count weight and the
// bin from the site's index and three per-axis tables of (dk_mu k_mu)^2
// (in the real type, in numpy's order: ((x + y) + z), sqrt, then rint of the
// quotient by the bin width, as PowerSpectra's host arrays are made). The
// partials (units x bins) are written once and read once by the finish.
// -fmad=false keeps K14's weight as the plain version rounds it.
//
// What holds a binning kernel below that bound is the bytes it keeps in
// flight and the instructions it spends a site. The design:
//
// - K13 counts: each thread takes 16 consecutive bins a step as four
//   16-byte loads, the next step's four issued before this step's bins are
//   used; it merges neighbours of one bin into runs in registers and adds
//   each run's length to the block's histogram with a shared-memory
//   integer atomicAdd (PK_COUNT_COPIES interleaved copies, copy b * C +
//   lane % C, against hot bins). Integer sums do not depend on their order,
//   so the counts are exact and repeat bit for bit. A unit whose first bin
//   is not 16-byte aligned takes scalar loads; a ragged tail of Z % 4 bins
//   is added one bin a thread.
// - K14: a warp takes a piece of a z-row of the unit (a whole row where
//   nzk <= 32 * PK_SPECTRA_SPL, 257 sites at 512^3; longer rows in equal
//   segments), each lane PK_SPECTRA_SPL or fewer consecutive sites, the
//   next piece's loads issued a piece ahead. A lane sums the float64
//   weights of its runs of one bin in z order; a segmented suffix sum over
//   the lanes (shuffles, a fixed tree) joins the runs that cross lane
//   boundaries, and one lane adds each run's total to the warp's
//   histogram. Where the z table of (dk_z k_z)^2 never falls (the r2c half
//   spectrum; the block checks it) the bins never fall along a row either
//   (the add, sqrt, the division by a positive width and rint are
//   monotone), so every bin of a piece is one run and no two lanes add to
//   one bin. Where it does fall (c2c, any other table) every site goes
//   through the warp grouping below (lanes of a bin grouped with
//   __match_any_sync, each group's weights added in lane order). A warp's
//   pieces follow in a fixed order, and the warps' histograms are added in
//   warp order at the unit's end: a unit's float64 additions depend only
//   on its contents and its global position. What holds it is the
//   per-site work the contract keeps (sqrt, an IEEE division, rint, hypot,
//   a float64 convert and add), and the registers that work takes: 64 a
//   thread fit four blocks an SM.
// - The float64-weighted K13 entry points bin every site through the warp
//   grouping: each warp owns a histogram, lanes of a bin are grouped by
//   __match_any_sync, and the group's lowest lane adds the group's weights
//   in lane order; the warps' histograms are added in warp order. They are
//   on no main path.
//
// PK_HIST_MATCH 1 builds the grouping for counts and K14 too, every site
// through it: the yardstick the run designs are timed beside.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pk_model.cuh"

#ifndef PK_HIST_MATCH
#define PK_HIST_MATCH 0
#endif

#define HIST_THREADS 256
#define HIST_WARPS (HIST_THREADS / 32)
// K14: the most sites a lane takes of a piece of a row (a whole row of
// the 512^3 half spectrum, 257 sites, is one piece)
#define PK_SPECTRA_SPL 9
// K13 counts: 16-byte loads a thread issues a step (4 bins each), and the
// interleaved copies of the block's histogram
#define PK_COUNT_VEC 4
#define PK_COUNT_COPIES 4
// K14: the blocks an SM its registers are fitted to (64 registers a
// thread; left free, nvcc takes more and fewer blocks fit)
#define PK_SPECTRA_MINB 4

// one warp's contribution of this step: the group of lanes sharing `b`
// adds its count or its weights (lane order) to the warp's histogram
template <bool WEIGHTED, class Acc>
__device__ __forceinline__ void pk_hist_step(Acc* mine, double* stage,
                                             int lane, int b, double w,
                                             int nbins) {
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const int leader = __ffs(peers) - 1;
  if (WEIGHTED) stage[lane] = w;
  __syncwarp();
  if (lane == leader && b >= 0 && b < nbins) {
    if (WEIGHTED) {
      double sum = 0.0;
      for (unsigned m = peers; m; m &= m - 1) sum += stage[__ffs(m) - 1];
      mine[b] += (Acc)sum;
    } else {
      mine[b] += (Acc)__popc(peers);
    }
  }
  __syncwarp();
}

// the histograms' zeroing, and their sum in warp order into the unit's row
template <class Acc>
__device__ __forceinline__ void pk_hist_zero(Acc* hist, int n) {
  for (int i = threadIdx.x; i < n; i += HIST_THREADS) hist[i] = 0;
  __syncthreads();
}

template <class Acc>
__device__ __forceinline__ void pk_hist_store(const Acc* hist, Acc* row,
                                              int nbins) {
  __syncthreads();
  for (int k = threadIdx.x; k < nbins; k += HIST_THREADS) {
    Acc a = hist[k];
    for (int w = 1; w < HIST_WARPS; ++w) a += hist[w * nbins + k];
    row[k] = a;
  }
}

// where this block's unit lies: element offset of the unit in the input,
// and its row in the partials (nouter, nunits, nbins)
struct PkUnit {
  long long elem, row;
  int lx, ly0;
};

__device__ __forceinline__ PkUnit pk_unit(int bx, int by, int Z, int ry,
                                          int ux0, int uyr0, int nyr,
                                          long long nunits) {
  const int runs = by / ry;
  const int lx = blockIdx.x / runs, j = blockIdx.x % runs;
  const int o = blockIdx.y;
  PkUnit u;
  u.lx = lx;
  u.ly0 = j * ry;
  u.elem = (((long long)o * bx + lx) * by + (long long)j * ry) * Z;
  u.row = (long long)o * nunits + (long long)(ux0 + lx) * nyr + uyr0 + j;
  return u;
}

// the warp histograms' bytes, and where the grouping's staging rows begin
template <class Acc>
__host__ __device__ __forceinline__ size_t pk_stage_offset(int nbins) {
  return ((size_t)HIST_WARPS * nbins * sizeof(Acc) + 15) / 16 * 16;
}

// K13 by warp grouping: float64 sums of weights W (and, in the
// PK_HIST_MATCH build, int32 counts, W unread)
template <bool WEIGHTED, class W, class Acc>
__global__ void __launch_bounds__(HIST_THREADS)
pk_bincount_kernel(const int* __restrict__ bins, const W* __restrict__ wts,
                   Acc* __restrict__ partials, int bx, int by, int Z,
                   int nbins, int ry, int ux0, int uyr0, int nyr,
                   long long nunits) {
  extern __shared__ __align__(16) unsigned char pk_hist_buf[];
  Acc* hist = reinterpret_cast<Acc*>(pk_hist_buf);
  double* stage = reinterpret_cast<double*>(
      pk_hist_buf + pk_stage_offset<Acc>(nbins));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const PkUnit u = pk_unit(bx, by, Z, ry, ux0, uyr0, nyr, nunits);
  pk_hist_zero(hist, HIST_WARPS * nbins);
  const long long L = (long long)ry * Z;
  const long long iters = (L + HIST_THREADS - 1) / HIST_THREADS;
  for (long long it = 0; it < iters; ++it) {
    const long long s = it * HIST_THREADS + threadIdx.x;
    int b = -1;
    double w = 0.0;
    if (s < L) {
      b = bins[u.elem + s];
      if (WEIGHTED) w = (double)wts[u.elem + s];
    }
    pk_hist_step<WEIGHTED>(hist + warp * nbins, stage + warp * 32, lane, b,
                           w, nbins);
  }
  pk_hist_store(hist, partials + u.row * nbins, nbins);
}

// K13 counts: N consecutive bins of one thread merged into runs, each run's
// length added to copy `mine` (stride C) of the block's histogram
template <int N, int C>
__device__ __forceinline__ void pk_count_runs(int* mine, const int (&b)[N],
                                              unsigned nbins) {
  int start = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool end = (i == N - 1) | (b[i] != b[i < N - 1 ? i + 1 : i]);
    if (end) {
      if ((unsigned)b[i] < nbins) atomicAdd(mine + b[i] * C, i + 1 - start);
      start = i + 1;
    }
  }
}

__device__ __forceinline__ void pk_count_load(int4 (&v)[PK_COUNT_VEC],
                                              const int4* __restrict__ src,
                                              long long i0, long long nv) {
#pragma unroll
  for (int j = 0; j < PK_COUNT_VEC; ++j)
    v[j] = i0 + j < nv ? src[i0 + j] : make_int4(-1, -1, -1, -1);
}

template <int C>
__global__ void __launch_bounds__(HIST_THREADS)
pk_count_kernel(const int* __restrict__ bins, int* __restrict__ partials,
                int bx, int by, int Z, int nbins, int ry, int ux0, int uyr0,
                int nyr, long long nunits) {
  constexpr int N = 4 * PK_COUNT_VEC;
  extern __shared__ __align__(16) unsigned char pk_hist_buf[];
  int* hist = reinterpret_cast<int*>(pk_hist_buf);
  const PkUnit u = pk_unit(bx, by, Z, ry, ux0, uyr0, nyr, nunits);
  pk_hist_zero(hist, C * nbins);
  int* mine = hist + threadIdx.x % C;
  const int* src = bins + u.elem;
  const long long L = (long long)ry * Z;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // 16-byte loads: thread t takes 16-byte words t * VEC ... of a step
    const int4* v = reinterpret_cast<const int4*>(src);
    const long long nv = L / 4, step = (long long)HIST_THREADS * PK_COUNT_VEC;
    const long long i0 = (long long)threadIdx.x * PK_COUNT_VEC;
    int4 cur[PK_COUNT_VEC];
    pk_count_load(cur, v, i0, nv);
    for (long long s = 0; s < nv; s += step) {
      int4 nxt[PK_COUNT_VEC];
      pk_count_load(nxt, v, s + step + i0, nv);
      int b[N];
#pragma unroll
      for (int j = 0; j < PK_COUNT_VEC; ++j) {
        b[4 * j] = cur[j].x;
        b[4 * j + 1] = cur[j].y;
        b[4 * j + 2] = cur[j].z;
        b[4 * j + 3] = cur[j].w;
        cur[j] = nxt[j];
      }
      pk_count_runs<N, C>(mine, b, (unsigned)nbins);
    }
    // the ragged tail: L % 4 bins, one a thread
    const long long t = nv * 4 + threadIdx.x;
    if (t < L) {
      const int bt = src[t];
      if ((unsigned)bt < (unsigned)nbins) atomicAdd(mine + bt * C, 1);
    }
  } else {
    // a misaligned unit: the same runs of N bins from scalar loads
    for (long long s = 0; s < L; s += (long long)HIST_THREADS * N) {
      const long long i0 = s + (long long)threadIdx.x * N;
      int b[N];
#pragma unroll
      for (int j = 0; j < N; ++j) b[j] = i0 + j < L ? src[i0 + j] : -1;
      pk_count_runs<N, C>(mine, b, (unsigned)nbins);
    }
  }
  __syncthreads();
  int* row = partials + u.row * nbins;
  for (int k = threadIdx.x; k < nbins; k += HIST_THREADS) {
    int a = hist[k * C];
#pragma unroll
    for (int c = 1; c < C; ++c) a += hist[k * C + c];
    row[k] = a;
  }
}

template <class R> struct PkComplex;
template <> struct PkComplex<float> { typedef float2 type; };
template <> struct PkComplex<double> { typedef double2 type; };

__device__ __forceinline__ float pk_hypot(float a, float b) {
  return hypotf(a, b);
}
__device__ __forceinline__ double pk_hypot(double a, double b) {
  return hypot(a, b);
}
__device__ __forceinline__ float pk_rint(float a) { return rintf(a); }
__device__ __forceinline__ double pk_rint(double a) { return rint(a); }

// |k|^p as torch.pow(tensor, p) forms it for these exponents
template <class R>
__device__ __forceinline__ R pk_kpow(R k, int ipow, R p) {
  switch (ipow) {
    case 0: return R(1);
    case 1: return k;
    case 2: return k * k;
    case 3: return k * k * k;
    default: return pow(k, p);
  }
}

// K14's arguments, shared by both designs
template <class R>
struct PkSpectra {
  const typename PkComplex<R>::type* __restrict__ fk;
  const R* __restrict__ sqx;
  const R* __restrict__ sqy;
  const R* __restrict__ sqz;
  R bin_width, p;
  int ipow, nz, is_real, gx0, gy0;
};

// a site's count weight times |k|^p |fk|^2, in the real type, as float64
template <class R>
__device__ __forceinline__ double pk_spectra_weight(
    const PkSpectra<R>& a, R kmag, int iz,
    typename PkComplex<R>::type v) {
  const R cnt = (a.is_real && iz != 0 && iz != a.nz / 2) ? R(2) : R(1);
  const R mod = pk_hypot(v.x, v.y);
  return (double)((cnt * pk_kpow(kmag, a.ipow, a.p)) * (mod * mod));
}

// K14 site by site: counts * |k|^p * |fk|^2 binned into rint(|k| /
// bin_width), float64 sums, every site through the warp grouping (the
// PK_HIST_MATCH yardstick); the input is an (outer, bx, by,
// nzk) block of the half spectrum (r2c) or of the full one (c2c) at global
// offset (gx0, gy0)
template <class R>
__global__ void __launch_bounds__(HIST_THREADS)
pk_spectra_bin_kernel(PkSpectra<R> a, double* __restrict__ partials,
                      int bx, int by, int nzk, int nbins, int ry, int ux0,
                      int uyr0, int nyr, long long nunits) {
  extern __shared__ __align__(16) unsigned char pk_hist_buf[];
  double* hist = reinterpret_cast<double*>(pk_hist_buf);
  double* stage = reinterpret_cast<double*>(
      pk_hist_buf + pk_stage_offset<double>(nbins));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const PkUnit u = pk_unit(bx, by, nzk, ry, ux0, uyr0, nyr, nunits);
  pk_hist_zero(hist, HIST_WARPS * nbins);
  const R qx = a.sqx[a.gx0 + u.lx];
  const long long L = (long long)ry * nzk;
  const long long iters = (L + HIST_THREADS - 1) / HIST_THREADS;
  for (long long it = 0; it < iters; ++it) {
    const long long s = it * HIST_THREADS + threadIdx.x;
    int b = -1;
    double w = 0.0;
    if (s < L) {
      const int ly = u.ly0 + (int)(s / nzk), iz = (int)(s % nzk);
      const R kmag = sqrt((qx + a.sqy[a.gy0 + ly]) + a.sqz[iz]);
      b = (int)pk_rint(kmag / a.bin_width);
      w = pk_spectra_weight(a, kmag, iz, a.fk[u.elem + s]);
    }
    pk_hist_step<true>(hist + warp * nbins, stage + warp * 32, lane, b, w,
                       nbins);
  }
  pk_hist_store(hist, partials + u.row * nbins, nbins);
}

// K14 by runs: a warp's piece is one segment of one z-row of the unit; a
// lane takes `cnt` (at most PK_SPECTRA_SPL) consecutive sites of it from
// z = `start`; `prev` says the lane before holds sites of the piece
struct PkPiece {
  int row, start, cnt;
  bool prev;
};

// the pieces of a unit: `nseg` equal segments a row, `ry` rows; with one
// segment a row (nzk <= 32 * PK_SPECTRA_SPL) a lane's sites sit at the
// same z in every row, found once
struct PkPieces {
  int nseg, nzk, lane;
  PkPiece first;

  __device__ __forceinline__ PkPieces(int nzk_, int lane_)
      : nseg((nzk_ + 32 * PK_SPECTRA_SPL - 1) / (32 * PK_SPECTRA_SPL)),
        nzk(nzk_), lane(lane_) {
    first = split(0, 0);
  }

  __device__ __forceinline__ PkPiece split(int row, int seg) const {
    PkPiece pc;
    pc.row = row;
    const int s0 = seg * nzk / nseg;
    const int len = (seg + 1) * nzk / nseg - s0;
    const int q = len >> 5, rem = len & 31;
    pc.start = s0 + lane * q + min(lane, rem);
    pc.cnt = q + (lane < rem);
    pc.prev = lane > 0 && q + (lane - 1 < rem) > 0;
    return pc;
  }

  __device__ __forceinline__ PkPiece operator()(int p) const {
    if (nseg == 1) {
      PkPiece pc = first;
      pc.row = p;
      return pc;
    }
    const int row = p / nseg;
    return split(row, p - row * nseg);
  }
};

template <class R>
__device__ __forceinline__ void pk_spectra_load(
    typename PkComplex<R>::type (&v)[PK_SPECTRA_SPL],
    const typename PkComplex<R>::type* __restrict__ row, const PkPiece& pc,
    bool live) {
#pragma unroll
  for (int j = 0; j < PK_SPECTRA_SPL; ++j)
    if (live && j < pc.cnt) v[j] = row[pc.start + j];
}

// add `s` to bin `b` of the warp's histogram (bins out of range dropped)
__device__ __forceinline__ void pk_spectra_flush(double* mine, int b,
                                                 double s, int nbins) {
  if ((unsigned)b < (unsigned)nbins) mine[b] += s;
}

// a site's bin and weight
template <class R>
__device__ __forceinline__ int pk_spectra_site(
    const PkSpectra<R>& a, R qxy, int iz, typename PkComplex<R>::type v,
    double& w) {
  const R kmag = sqrt(qxy + a.sqz[iz]);
  w = pk_spectra_weight(a, kmag, iz, v);
  return (int)pk_rint(kmag / a.bin_width);
}

// one piece whose bins never fall along z (the block found the z table
// non-decreasing): each lane sums its runs of one bin in z order, adds the
// runs inside it at once (no other lane of the piece holds their bin) and
// keeps its first (hb, hs) and last (cb, cs); a lane's first run continues
// the lane before's last where their bins agree, and the run's total
// gathers, lane by lane to the right, the first runs that continue it: a
// segmented suffix sum, A = hs + (A of the next lane where this lane is
// one run), in a fixed tree of shuffles
template <class R>
__device__ __forceinline__ void pk_spectra_runs(
    const PkSpectra<R>& a, double* mine, int lane, R qxy, const PkPiece& pc,
    const typename PkComplex<R>::type (&v)[PK_SPECTRA_SPL], int nbins) {
  const unsigned full = 0xffffffffu;
  int hb = -1, cb = -1;
  double hs = 0.0, cs = 0.0;
  bool single = true;
#pragma unroll
  for (int j = 0; j < PK_SPECTRA_SPL; ++j) {
    if (j < pc.cnt) {
      double w;
      const int b = pk_spectra_site(a, qxy, pc.start + j, v[j], w);
      if (j == 0) {
        hb = cb = b;
      } else if (b != cb) {
        if (single) {
          hs = cs;
          single = false;
        } else {
          pk_spectra_flush(mine, cb, cs, nbins);
        }
        cb = b;
        cs = 0.0;
      }
      cs += w;
    }
  }
  if (single) hs = cs;
  const int prev_cb = __shfl_up_sync(full, cb, 1);
  const bool cont = pc.cnt > 0 && pc.prev && hb == prev_cb;
  double acc = cont ? hs : 0.0;
  int open = cont && single;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double an = __shfl_down_sync(full, acc, o);
    const int on = __shfl_down_sync(full, open, o);
    if (open && lane + o < 32) {
      acc = acc + an;
      open = on;
    }
  }
  double right = __shfl_down_sync(full, acc, 1);
  if (lane == 31) right = 0.0;
  if (pc.cnt > 0) {
    if (!single && !cont) pk_spectra_flush(mine, hb, hs, nbins);
    if (!(single && cont))
      pk_spectra_flush(mine, cb, cs + right, nbins);
  }
}

// one piece of any bins: site by site through the warp grouping
template <class R>
__device__ __forceinline__ void pk_spectra_sites(
    const PkSpectra<R>& a, double* mine, double* stage, int lane, R qxy,
    const PkPiece& pc, const typename PkComplex<R>::type (&v)[PK_SPECTRA_SPL],
    int nbins) {
#pragma unroll
  for (int j = 0; j < PK_SPECTRA_SPL; ++j) {
    int b = -1;
    double w = 0.0;
    if (j < pc.cnt) b = pk_spectra_site(a, qxy, pc.start + j, v[j], w);
    pk_hist_step<true>(mine, stage, lane, b, w, nbins);
  }
}

template <class R>
__global__ void __launch_bounds__(HIST_THREADS, PK_SPECTRA_MINB)
pk_spectra_run_kernel(PkSpectra<R> a, double* __restrict__ partials,
                      int bx, int by, int nzk, int nbins, int ry, int ux0,
                      int uyr0, int nyr, long long nunits) {
  typedef typename PkComplex<R>::type V;
  extern __shared__ __align__(16) unsigned char pk_hist_buf[];
  double* hist = reinterpret_cast<double*>(pk_hist_buf);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* stage = reinterpret_cast<double*>(
      pk_hist_buf + pk_stage_offset<double>(nbins)) + warp * 32;
  double* mine = hist + warp * nbins;
  const PkUnit u = pk_unit(bx, by, nzk, ry, ux0, uyr0, nyr, nunits);
  // the bins never fall along z where the z table never does (the add,
  // sqrt, a division by a positive width and rint are monotone)
  bool rising = a.bin_width > R(0);
  for (int iz = threadIdx.x + 1; iz < nzk; iz += HIST_THREADS)
    rising = rising && a.sqz[iz] >= a.sqz[iz - 1];
  pk_hist_zero(hist, HIST_WARPS * nbins);
  rising = __syncthreads_and(rising);
  const R qx = a.sqx[a.gx0 + u.lx];
  const PkPieces pieces(nzk, lane);
  const int npieces = ry * pieces.nseg;
  const V* unit = a.fk + u.elem;
  // every warp takes the same number of rounds (the last may be idle), so
  // its warp-wide steps stay in step with the others'; the next piece's
  // loads are issued before this piece's sites are binned
  PkPiece pc = pieces(warp);
  V v[PK_SPECTRA_SPL];
  pk_spectra_load<R>(v, unit + (long long)pc.row * nzk, pc, warp < npieces);
  for (int p0 = 0; p0 < npieces; p0 += HIST_WARPS) {
    const int p = p0 + warp;
    const bool live = p < npieces;
    V vn[PK_SPECTRA_SPL];
    const PkPiece pn = pieces(p + HIST_WARPS);
    pk_spectra_load<R>(vn, unit + (long long)pn.row * nzk, pn,
                       p + HIST_WARPS < npieces);
    PkPiece here = pc;
    if (!live) here.cnt = 0;
    const R qxy = qx + a.sqy[a.gy0 + u.ly0 + (live ? pc.row : 0)];
    if (rising)
      pk_spectra_runs<R>(a, mine, lane, qxy, here, v, nbins);
    else
      pk_spectra_sites<R>(a, mine, stage, lane, qxy, here, v, nbins);
    __syncwarp();
    pc = pn;
#pragma unroll
    for (int j = 0; j < PK_SPECTRA_SPL; ++j) v[j] = vn[j];
  }
  pk_hist_store(hist, partials + u.row * nbins, nbins);
}

// the finish: every unit's row summed, per (outer, bin); warp w of a block
// takes the units u = w, w + 32, ... in order, then the 32 warps' sums are
// added in warp order
template <class P, class O>
__global__ void __launch_bounds__(1024)
pk_bin_finish_kernel(const P* __restrict__ partials, O* __restrict__ out,
                     int nbins, long long nunits) {
  __shared__ O red[32][33];
  const int lane = threadIdx.x, w = threadIdx.y, o = blockIdx.y;
  const int b = blockIdx.x * 32 + lane;
  O acc = 0;
  if (b < nbins)
    for (long long u = w; u < nunits; u += 32)
      acc += (O)partials[((long long)o * nunits + u) * nbins + b];
  red[w][lane] = acc;
  __syncthreads();
  if (w == 0 && b < nbins) {
    O t = red[0][lane];
    for (int k = 1; k < 32; ++k) t += red[k][lane];
    out[(long long)o * nbins + b] = t;
  }
}

// dynamic shared bytes a block: warp histograms and the grouping's staging
// rows (the weighted entry points, K14, and counts in PK_HIST_MATCH), or the
// interleaved copies of one count histogram
template <class Acc>
static size_t pk_hist_smem_bytes(int nbins) {
  return pk_stage_offset<Acc>(nbins) + HIST_WARPS * 32 * sizeof(double);
}


static size_t pk_count_smem_bytes(int nbins) {
#if PK_HIST_MATCH
  return pk_hist_smem_bytes<int>(nbins);
#else
  return ((size_t)PK_COUNT_COPIES * nbins * sizeof(int) + 15) / 16 * 16;
#endif
}

template <bool WEIGHTED, class W, class Acc>
static int pk_bincount_launch(const void* bins, const void* w, void* partials,
                              int nouter, int bx, int by, int Z, int nbins,
                              int ry, int ux0, int uyr0, int nyr,
                              long long nunits, void* stream) {
  const size_t smem = pk_hist_smem_bytes<Acc>(nbins);
  cudaFuncSetAttribute(pk_bincount_kernel<WEIGHTED, W, Acc>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((unsigned)(bx * (by / ry)), (unsigned)nouter);
  pk_bincount_kernel<WEIGHTED, W, Acc><<<grid, HIST_THREADS, smem,
                                         (cudaStream_t)stream>>>(
      (const int*)bins, (const W*)w, (Acc*)partials, bx, by, Z, nbins, ry,
      ux0, uyr0, nyr, nunits);
  return (int)cudaGetLastError();
}

static int pk_count_launch(const void* bins, void* partials, int nouter,
                           int bx, int by, int Z, int nbins, int ry, int ux0,
                           int uyr0, int nyr, long long nunits,
                           void* stream) {
#if PK_HIST_MATCH
  return pk_bincount_launch<false, float, int>(bins, nullptr, partials,
                                               nouter, bx, by, Z, nbins, ry,
                                               ux0, uyr0, nyr, nunits,
                                               stream);
#else
  const size_t smem = pk_count_smem_bytes(nbins);
  cudaFuncSetAttribute(pk_count_kernel<PK_COUNT_COPIES>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((unsigned)(bx * (by / ry)), (unsigned)nouter);
  pk_count_kernel<PK_COUNT_COPIES><<<grid, HIST_THREADS, smem,
                                    (cudaStream_t)stream>>>(
      (const int*)bins, (int*)partials, bx, by, Z, nbins, ry, ux0, uyr0, nyr,
      nunits);
  return (int)cudaGetLastError();
#endif
}

template <class R>
static int pk_spectra_launch(const void* fk, const void* sqx, const void* sqy,
                             const void* sqz, double bin_width, int ipow,
                             double p, int nz, int is_real, int gx0, int gy0,
                             void* partials, int nouter, int bx, int by,
                             int nzk, int nbins, int ry, int ux0, int uyr0,
                             int nyr, long long nunits, void* stream) {
  PkSpectra<R> a;
  a.fk = (const typename PkComplex<R>::type*)fk;
  a.sqx = (const R*)sqx;
  a.sqy = (const R*)sqy;
  a.sqz = (const R*)sqz;
  a.bin_width = (R)bin_width;
  a.p = (R)p;
  a.ipow = ipow;
  a.nz = nz;
  a.is_real = is_real;
  a.gx0 = gx0;
  a.gy0 = gy0;
  const size_t smem = pk_hist_smem_bytes<double>(nbins);
#if PK_HIST_MATCH
  auto kernel = pk_spectra_bin_kernel<R>;
#else
  auto kernel = pk_spectra_run_kernel<R>;
#endif
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((unsigned)(bx * (by / ry)), (unsigned)nouter);
  kernel<<<grid, HIST_THREADS, smem, (cudaStream_t)stream>>>(
      a, (double*)partials, bx, by, nzk, nbins, ry, ux0, uyr0, nyr, nunits);
  return (int)cudaGetLastError();
}

template <class P, class O>
static int pk_finish_launch(const void* partials, void* out, int nouter,
                            int nbins, long long nunits, void* stream) {
  const dim3 grid((unsigned)((nbins + 31) / 32), (unsigned)nouter);
  pk_bin_finish_kernel<P, O><<<grid, dim3(32, 32), 0,
                               (cudaStream_t)stream>>>(
      (const P*)partials, (O*)out, nbins, nunits);
  return (int)cudaGetLastError();
}

#define PK_BINCOUNT_ARGS                                                    \
  void *partials, int nouter, int bx, int by, int Z, int nbins, int ry,     \
      int ux0, int uyr0, int nyr, long long nunits, void *stream
#define PK_BINCOUNT_PASS \
  partials, nouter, bx, by, Z, nbins, ry, ux0, uyr0, nyr, nunits, stream

extern "C" {

// the dynamic shared memory a block of the count entry point, or of the
// float64 ones (K13's weighted and K14), takes (the host refuses a bin
// count above the card's limit before it launches)
size_t pk_hist_smem(int weighted, int nbins) {
  return weighted ? pk_hist_smem_bytes<double>(nbins)
                  : pk_count_smem_bytes(nbins);
}

int pk_bincount_count(const void* bins, PK_BINCOUNT_ARGS) {
  return pk_count_launch(bins, PK_BINCOUNT_PASS);
}

int pk_bincount_f32(const void* bins, const void* w, PK_BINCOUNT_ARGS) {
  return pk_bincount_launch<true, float, double>(bins, w, PK_BINCOUNT_PASS);
}

int pk_bincount_f64(const void* bins, const void* w, PK_BINCOUNT_ARGS) {
  return pk_bincount_launch<true, double, double>(bins, w, PK_BINCOUNT_PASS);
}

#define PK_SPECTRA_ENTRY(name, R)                                            \
  int name(const void* fk, const void* sqx, const void* sqy,                 \
           const void* sqz, double bin_width, int ipow, double p, int nz,    \
           int is_real, int gx0, int gy0, void* partials, int nouter,        \
           int bx, int by, int nzk, int nbins, int ry, int ux0, int uyr0,    \
           int nyr, long long nunits, void* stream) {                        \
    return pk_spectra_launch<R>(fk, sqx, sqy, sqz, bin_width, ipow, p, nz,   \
                                is_real, gx0, gy0, partials, nouter, bx, by, \
                                nzk, nbins, ry, ux0, uyr0, nyr, nunits,      \
                                stream);                                     \
  }
PK_SPECTRA_ENTRY(pk_spectra_bin_f32, float)
PK_SPECTRA_ENTRY(pk_spectra_bin_f64, double)

int pk_bin_finish_count(const void* partials, void* out, int nouter,
                        int nbins, long long nunits, void* stream) {
  return pk_finish_launch<int, long long>(partials, out, nouter, nbins,
                                          nunits, stream);
}

int pk_bin_finish_sum(const void* partials, void* out, int nouter, int nbins,
                      long long nunits, void* stream) {
  return pk_finish_launch<double, double>(partials, out, nouter, nbins,
                                          nunits, stream);
}

}  // extern "C"
