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
// Inside a unit no atomics race: each warp owns a histogram in shared
// memory. Per step the block's 256 threads take 256 consecutive elements;
// lanes of a warp with equal bins are grouped (__match_any_sync), the
// group's lowest lane adds the group's weights in lane order to its warp's
// histogram (or the group's size, for counts), and after the walk the
// warps' histograms are added in warp order.
//
// Bound: bytes. K13 reads its int32 bins (and weights) once; K14 reads the
// complex half spectrum once and derives |k|, the r2c count weight and the
// bin from the site's index and three per-axis tables of (dk_mu k_mu)^2
// (in the real type, in numpy's order: ((x + y) + z), sqrt, then rint of the
// quotient by the bin width, as PowerSpectra's host arrays are made). The
// partials (units x bins) are written once and read once by the finish.
// -fmad=false keeps K14's weight as the plain version rounds it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define HIST_THREADS 256
#define HIST_WARPS (HIST_THREADS / 32)

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
__device__ __forceinline__ void pk_hist_zero(Acc* hist, int nbins) {
  for (int i = threadIdx.x; i < HIST_WARPS * nbins; i += HIST_THREADS)
    hist[i] = 0;
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

template <class Acc>
__host__ __device__ __forceinline__ size_t pk_stage_offset(int nbins) {
  return ((size_t)HIST_WARPS * nbins * sizeof(Acc) + 15) / 16 * 16;
}

// K13: counts (W = void) or float64 sums of weights W over int32 bins
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
  pk_hist_zero(hist, nbins);
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

// K14: counts * |k|^p * |fk|^2 binned into rint(|k| / bin_width), float64
// sums; the input is an (outer, bx, by, nzk) block of the half spectrum
// (r2c) or of the full one (c2c) at global offset (gx0, gy0)
template <class R>
__global__ void __launch_bounds__(HIST_THREADS)
pk_spectra_bin_kernel(const typename PkComplex<R>::type* __restrict__ fk,
                      const R* __restrict__ sqx, const R* __restrict__ sqy,
                      const R* __restrict__ sqz, R bin_width, int ipow, R p,
                      int nz, int is_real, int gx0, int gy0,
                      double* __restrict__ partials, int bx, int by,
                      int nzk, int nbins, int ry, int ux0, int uyr0,
                      int nyr, long long nunits) {
  extern __shared__ __align__(16) unsigned char pk_hist_buf[];
  double* hist = reinterpret_cast<double*>(pk_hist_buf);
  double* stage = reinterpret_cast<double*>(
      pk_hist_buf + pk_stage_offset<double>(nbins));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const PkUnit u = pk_unit(bx, by, nzk, ry, ux0, uyr0, nyr, nunits);
  pk_hist_zero(hist, nbins);
  const R qx = sqx[gx0 + u.lx];
  const long long L = (long long)ry * nzk;
  const long long iters = (L + HIST_THREADS - 1) / HIST_THREADS;
  for (long long it = 0; it < iters; ++it) {
    const long long s = it * HIST_THREADS + threadIdx.x;
    int b = -1;
    double w = 0.0;
    if (s < L) {
      const int ly = u.ly0 + (int)(s / nzk), iz = (int)(s % nzk);
      const R kmag = sqrt((qx + sqy[gy0 + ly]) + sqz[iz]);
      b = (int)pk_rint(kmag / bin_width);
      const R cnt = (is_real && iz != 0 && iz != nz / 2) ? R(2) : R(1);
      const typename PkComplex<R>::type v = fk[u.elem + s];
      const R mod = pk_hypot(v.x, v.y);
      w = (double)((cnt * pk_kpow(kmag, ipow, p)) * (mod * mod));
    }
    pk_hist_step<true>(hist + warp * nbins, stage + warp * 32, lane, b, w,
                       nbins);
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

template <class Acc>
static size_t pk_hist_smem_bytes(int nbins) {
  return pk_stage_offset<Acc>(nbins) + HIST_WARPS * 32 * sizeof(double);
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

template <class R>
static int pk_spectra_launch(const void* fk, const void* sqx, const void* sqy,
                             const void* sqz, double bin_width, int ipow,
                             double p, int nz, int is_real, int gx0, int gy0,
                             void* partials, int nouter, int bx, int by,
                             int nzk, int nbins, int ry, int ux0, int uyr0,
                             int nyr, long long nunits, void* stream) {
  const size_t smem = pk_hist_smem_bytes<double>(nbins);
  cudaFuncSetAttribute(pk_spectra_bin_kernel<R>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((unsigned)(bx * (by / ry)), (unsigned)nouter);
  pk_spectra_bin_kernel<R><<<grid, HIST_THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const typename PkComplex<R>::type*)fk, (const R*)sqx, (const R*)sqy,
      (const R*)sqz, (R)bin_width, ipow, (R)p, nz, is_real, gx0, gy0,
      (double*)partials, bx, by, nzk, nbins, ry, ux0, uyr0, nyr, nunits);
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

// the dynamic shared memory a block of each entry point takes (the host
// refuses a bin count above the card's limit before it launches)
size_t pk_hist_smem(int weighted, int nbins) {
  return weighted ? pk_hist_smem_bytes<double>(nbins)
                  : pk_hist_smem_bytes<int>(nbins);
}

int pk_bincount_count(const void* bins, PK_BINCOUNT_ARGS) {
  return pk_bincount_launch<false, float, int>(bins, nullptr,
                                               PK_BINCOUNT_PASS);
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
