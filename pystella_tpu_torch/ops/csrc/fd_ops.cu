// K12: the finite-difference operators of FiniteDifferencer on one device:
// lap (C -> C), grad (C -> C x 3), grad_lap (both from one read), pdx, pdy,
// pdz (C -> C) and div (3n -> n), centered differences of order 2h on a
// periodic lattice.
//
// Replaces the Pallas bodies of FiniteDifferencer._pallas_bodies
// (pystella_tpu/ops/derivs.py: lap_of, grad_of, pd_body, div_body), run by
// StreamingStencil / ResidentStencil (pystella_tpu/ops/pallas_stencil.py).
// Unlike the fused kernels it is not model-specific: the generated header
// defines PK_H alone (one library per stencil radius, so the tap loops
// unroll), and the component count C and the lattice shape are launch
// arguments.
//
// Arithmetic order, term by term as the JAX bodies accumulate:
//   lap      pk_lap: w0 * centre, then per offset the x, y and z pairs
//            (lap_from_taps);
//   grad     pk_grad: per axis from 0, per offset w * (plus - minus)
//            (grad_from_taps);
//   pd*      the same sum along one axis (pd_body);
//   div      one accumulator from 0, over the axes d and then the offsets,
//            w[d][s] * (v_d(+s) - v_d(-s)) (div_body).
// The weights are coef * (1 / dx^2) and coef * (1 / dx), formed on the host
// in double and cast to T (pk_lap_weights, pk_grad_weights).
//
// Bound: memory. Each input component-array is read once and each output
// written once (lap 2C, grad 4C, grad_lap 5C, pd 2C, div 4n arrays of
// sites * sizeof(T) bytes) against 3 + 9h (lap) or 9h (grad) operations a
// site and component. Design of pd*: one thread per site, z fastest, so the
// centre loads and every store are coalesced; the 2h neighbour taps are
// re-read through L1/L2; periodic wrap by index arithmetic on all three
// axes, so any lattice shape runs; the components are a loop inside the
// thread (the wrapped neighbour indices do not depend on the component),
// with 64-bit offsets (C * 512^3 passes 2^31 at C = 16). grad writes (C, 3,
// X, Y, Z), div reads (n, 3, X, Y, Z). Built with -fmad=false: no
// multiply-add is contracted where the plain PyTorch version rounds twice.
//
// lap, grad, grad_lap and div march instead (pk_fd_lap_kernel,
// pk_fd_grad_kernel, pk_fd_grad_lap_kernel, pk_fd_div_kernel): the x ring
// of the streaming Pallas kernel (StreamingStencil._build,
// pystella_tpu/ops/pallas_stencil.py:709) carried to a block. A block owns
// one y-z tile of one component (div: of one vector) and walks it along x
// over a run of PK_FD_LAP_LX (PK_FD_GRAD_LX, PK_FD_GRAD_LAP_LX,
// PK_FD_DIV_LX) planes, per tapped array the centre plane with its y-z halo
// in static shared memory (div's three under 15 KB at f64 and h = 4, each
// holding only the halo its array's derivative taps), the
// +-x taps in a queue of 2h+1 values in each thread's registers, the next
// plane's loads a step ahead (with PK_FD_GRAD_AHEAD, PK_FD_GRAD_LAP_AHEAD,
// PK_FD_DIV_AHEAD). grad, grad_lap and div run pk_queue_march of
// pk_common.cuh, the march K11 shares (div with its three arrays, NA = 3);
// lap keeps its own loop of the same design, since the shared template
// changed its registers and spills on an H100 (PERF.md). pk_lap, pk_grad
// and pk_pd run over the planes in box coordinates, so each march equals
// the per-site arithmetic bit for bit, and grad_lap's outputs equal grad's
// and lap's. Components go in grid-sized groups. ops/derivs.py:lap_tile,
// grad_tile, grad_lap_tile and div_tile mirror the tiles; pk_fd_lap_tile,
// pk_fd_grad_tile, pk_fd_grad_lap_tile and pk_fd_div_tile report them.
// PK_FD_PER_SITE 1 builds all four per site, as pk_fd_kernel runs pd*: the
// yardstick the smoke times them against.
//
// The sharded tier (the _xpad, _ypad, _xypad entry points) replaces the
// halo-input kernel StreamingStencil._build_xhalo
// (pystella_tpu/ops/pallas_stencil.py:789) and, through the interior and
// shell launches, OverlapStreamingStencil (:931) on these bodies, as
// FiniteDifferencer._pallas_op (pystella_tpu/ops/derivs.py:405) runs them
// on a sharded lattice: the same kernel with its input padded along x
// and/or y by the neighbours' rows (PAD, PkGeom in pk_common.cuh), read
// unwrapped there. The taps and sums are the unsharded kernel's, so a
// padded launch equals the unsharded one on the whole lattice bit for bit.
// The interior launch reads the raw block as its x-padded input and the
// shell launches a (C, 3h, Y, Z) slab; both write their x rows of the full
// output block in place (the output pointers start at the region's first
// row), so nothing is stitched afterwards. Bound: as above, plus the
// padded rows read once.
#include "pk_common.cuh"

enum PkFdOp { PK_FD_LAP, PK_FD_GRAD, PK_FD_GRAD_LAP, PK_FD_PDX, PK_FD_PDY,
              PK_FD_PDZ, PK_FD_DIV };

template <typename T>
struct PkFdWeights {
  PkLapWeights<T> lap;
  PkGradWeights<T> grad;
};

// The derivative along one axis (AXIS = 0, 1, 2): acc = 0, then per offset
// acc + w * (tap(+s) - tap(-s)). PAD as pk_grad's (PK_BOX: a march's
// loader, nothing wrapped).
template <typename T, int AXIS, int PAD, typename Load>
__device__ __forceinline__ T pk_pd(const Load& load, int x, int y, int z,
                                   int X, int Y, int Z,
                                   const PkGradWeights<T>& w, T acc) {
  constexpr bool PX = PAD & PK_PAD_X, PY = PAD & PK_PAD_Y;
  constexpr bool PZ = PAD & PK_PAD_Z;
#pragma unroll
  for (int s = 1; s <= PK_H; ++s) {
    if (AXIS == 0)
      acc = acc + w.wx[s - 1] * (load(pk_tap<PX>(x + s, X), y, z)
                                 - load(pk_tap<PX>(x - s, X), y, z));
    else if (AXIS == 1)
      acc = acc + w.wy[s - 1] * (load(x, pk_tap<PY>(y + s, Y), z)
                                 - load(x, pk_tap<PY>(y - s, Y), z));
    else
      acc = acc + w.wz[s - 1] * (load(x, y, pk_tap<PZ>(z + s, Z))
                                 - load(x, y, pk_tap<PZ>(z - s, Z)));
  }
  return acc;
}

// x planes a run of the Laplacian's march and of grad_lap's, and whether
// grad_lap's loads go a step ahead (fd_lap's always do): the fastest
// variants of chip_smoke.py --phases march_variants on an H100
#ifndef PK_FD_LAP_LX
#define PK_FD_LAP_LX 32
#endif
#ifndef PK_FD_GRAD_LAP_LX
#define PK_FD_GRAD_LAP_LX 32
#endif
#ifndef PK_FD_GRAD_LAP_AHEAD
#define PK_FD_GRAD_LAP_AHEAD 1
#endif
// grad's and div's, in the same form (grad's run of 16 beat 32 by 1-2% in
// four march_variants runs; div's 64 came within 0.3% of 32)
#ifndef PK_FD_GRAD_LX
#define PK_FD_GRAD_LX 16
#endif
#ifndef PK_FD_GRAD_AHEAD
#define PK_FD_GRAD_AHEAD 1
#endif
#ifndef PK_FD_DIV_LX
#define PK_FD_DIV_LX 32
#endif
#ifndef PK_FD_DIV_AHEAD
#define PK_FD_DIV_AHEAD 1
#endif
// 1: lap, grad, grad_lap and div run per site too (pk_fd_kernel), as the
// pd* operators do: the yardstick the smoke times the marches against and
// the card tests hold them to
#ifndef PK_FD_PER_SITE
#define PK_FD_PER_SITE 0
#endif

template <typename T>
using PkFdLapTile = PkQueueTile<T, 1, PK_FD_LAP_LX>;
template <typename T>
using PkFdGradLapTile = PkQueueTile<T, 1, PK_FD_GRAD_LAP_LX>;
template <typename T>
using PkFdGradTile = PkQueueTile<T, 1, PK_FD_GRAD_LX>;
// div taps the three arrays of a vector: three centre planes, 15 KB at f64
// and h = 4
template <typename T>
using PkFdDivTile = PkQueueTile<T, 3, PK_FD_DIV_LX>;
static_assert(PkFdDivTile<double>::FITS,
              "div's three centre planes exceed a block's static shared "
              "memory");

// The Laplacian's march: block (z tile, y tile, run + nruns * component)
// over an (X, Y, Z) region; window geometry as pk_fd_kernel's.
template <typename T, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
pk_fd_lap_kernel(const T* __restrict__ in, T* __restrict__ out, int X, int Y,
                 int Z, int nruns, PkLapWeights<T> w, PkGeom g) {
  using Tl = PkFdLapTile<T>;
  __shared__ T sm[Tl::CENTRE];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int own = ty * Tl::TZ + tz;
  const int z0 = blockIdx.x * Tl::TZ, y0 = blockIdx.y * Tl::TY;
  const int c = blockIdx.z / nruns;
  const int xs = (blockIdx.z - c * nruns) * Tl::LX;
  const int nx = min(Tl::LX, X - xs);
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t Nw = PAD ? g.Nw : N;
  const int Yw = PAD ? g.Ys : Y;
  const T* __restrict__ src = in + c * Nw;
  T* __restrict__ dst = out + c * N;
  const int z = z0 + tz, y = y0 + ty;
  const bool valid = z < Z && y < Y;
  // the window's value at point (x, yy, zz) of the region; a tile hanging
  // past a padded window's last row reads that row (no valid site taps it)
  auto at = [&](int x, int yy, int zz) {
    if (!(PAD & PK_PAD_X)) x = pk_wrap(x, X);
    yy = (PAD & PK_PAD_Y) ? min(yy, Y + PK_H - 1) : pk_wrap(yy, Y);
    return src[((int64_t)x * Yw + yy) * Z + pk_wrap(zz, Z)];
  };
  const int ctr = (ty + PK_H) * Tl::SZ + tz + PK_H;
  // this thread's first frame element, at the same place every plane
  const bool first = own < Tl::FRAME;
  int fy = 0, fz = 0;
  if (first) pk_frame_at(own, fy, fz);
  // planes xs - h .. xs + h - 1 of the thread's column: the queue's
  // 1 .. 2h; then plane xs + h and the first plane's frame element. Each
  // step stores the loads the step before issued and issues the next
  // plane's, so they are in flight across a whole step.
  PkQueueLoad<T> col{sm, {}};
  T* const q = col.q;
#pragma unroll
  for (int k = 0; k < 2 * PK_H; ++k) q[k + 1] = at(xs - PK_H + k, y, z);
  T next = at(xs + PK_H, y, z);
  T edge = first ? at(xs, y0 - PK_H + fy, z0 - PK_H + fz) : T(0);
  for (int i = 0; i < nx; ++i) {
    const int x = xs + i;
#pragma unroll
    for (int k = 0; k < 2 * PK_H; ++k) q[k] = q[k + 1];
    q[2 * PK_H] = next;
    sm[ctr] = q[PK_H];
    if (first) sm[fy * Tl::SZ + fz] = edge;
    if (i + 1 < nx) {
      next = at(x + PK_H + 1, y, z);
      if (first) edge = at(x + 1, y0 - PK_H + fy, z0 - PK_H + fz);
    }
    // the rest of the frame (h >= 3: more elements than threads)
    for (int k = own + Tl::THREADS; k < Tl::FRAME; k += Tl::THREADS) {
      int yy, zz;
      pk_frame_at(k, yy, zz);
      sm[yy * Tl::SZ + zz] = at(x, y0 - PK_H + yy, z0 - PK_H + zz);
    }
    __syncthreads();
    if (valid) {
      const int by = ty + PK_H, bz = tz + PK_H;
      dst[((int64_t)x * Y + y) * Z + z] =
          pk_lap<PK_BOX>(col, q[PK_H], PK_H, by, bz, 0, 0, 0, w);
    }
    __syncthreads();
  }
}

// grad_lap's march, as the Laplacian's: each block writes the three
// derivatives and the Laplacian of its component from the same taps.
template <typename T, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
pk_fd_grad_lap_kernel(const T* __restrict__ in, T* __restrict__ out0,
                      T* __restrict__ out1, int X, int Y, int Z, int nruns,
                      PkFdWeights<T> w, PkGeom g) {
  using Tl = PkFdGradLapTile<T>;
  const int c = blockIdx.z / nruns;
  const int xs = (blockIdx.z - c * nruns) * Tl::LX;
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t Nw = PAD ? g.Nw : N;
  T* __restrict__ grad = out0 + 3 * c * N;
  T* __restrict__ lap = out1 + c * N;
  const int z = blockIdx.x * Tl::TZ + threadIdx.x;
  const int y = blockIdx.y * Tl::TY + threadIdx.y;
  const bool valid = z < Z && y < Y;
  pk_queue_march<T, 1, PAD, PK_FD_GRAD_LAP_AHEAD>(
      PkQueueSrc<T, 1>{{in + c * Nw}}, X, Y, Z, PAD ? g.Ys : Y, xs,
      min(Tl::LX, X - xs), [](int) { return PkNoSite{}; },
      [&](int x, const PkQueueLoad<T> (&col)[1], PkNoSite) {
        if (!valid) return;
        const int64_t site = ((int64_t)x * Y + y) * Z + z;
        T g3[3];
        pk_queue_grad(col[0], w.grad, g3);
#pragma unroll
        for (int d = 0; d < 3; ++d) grad[d * N + site] = g3[d];
        lap[site] = pk_queue_lap(col[0], w.lap);
      });
}

// grad's march: grad_lap's without the Laplacian.
template <typename T, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
pk_fd_grad_kernel(const T* __restrict__ in, T* __restrict__ out0, int X,
                  int Y, int Z, int nruns, PkGradWeights<T> w, PkGeom g) {
  using Tl = PkFdGradTile<T>;
  const int c = blockIdx.z / nruns;
  const int xs = (blockIdx.z - c * nruns) * Tl::LX;
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t Nw = PAD ? g.Nw : N;
  T* __restrict__ grad = out0 + 3 * c * N;
  const int z = blockIdx.x * Tl::TZ + threadIdx.x;
  const int y = blockIdx.y * Tl::TY + threadIdx.y;
  const bool valid = z < Z && y < Y;
  pk_queue_march<T, 1, PAD, PK_FD_GRAD_AHEAD>(
      PkQueueSrc<T, 1>{{in + c * Nw}}, X, Y, Z, PAD ? g.Ys : Y, xs,
      min(Tl::LX, X - xs), [](int) { return PkNoSite{}; },
      [&](int x, const PkQueueLoad<T> (&col)[1], PkNoSite) {
        if (!valid) return;
        const int64_t site = ((int64_t)x * Y + y) * Z + z;
        T g3[3];
        pk_queue_grad(col[0], w, g3);
#pragma unroll
        for (int d = 0; d < 3; ++d) grad[d * N + site] = g3[d];
      });
}

// div's march over vector c, its three arrays tapped together (NA = 3):
// one accumulator from 0, v_x's x pairs, then v_y's y pairs, then v_z's z
// pairs (div_body's order, pk_fd_kernel's PK_FD_DIV branch).
template <typename T, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
pk_fd_div_kernel(const T* __restrict__ in, T* __restrict__ out0, int X,
                 int Y, int Z, int nruns, PkGradWeights<T> w, PkGeom g) {
  using Tl = PkFdDivTile<T>;
  const int c = blockIdx.z / nruns;
  const int xs = (blockIdx.z - c * nruns) * Tl::LX;
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t Nw = PAD ? g.Nw : N;
  const T* v = in + 3 * c * Nw;
  T* __restrict__ div = out0 + c * N;
  const int z = blockIdx.x * Tl::TZ + threadIdx.x;
  const int y = blockIdx.y * Tl::TY + threadIdx.y;
  const bool valid = z < Z && y < Y;
  // each array loads only the halo its derivative taps: v_x none, not even
  // its centre plane, v_y the frame's rows, v_z its columns (14% faster than
  // full frames on an H100, PERF.md)
  constexpr unsigned halo = (1u << 2) | (1u << 5);
  pk_queue_march<T, 3, PAD, PK_FD_DIV_AHEAD, halo>(
      PkQueueSrc<T, 3>{{v, v + Nw, v + 2 * Nw}}, X, Y, Z, PAD ? g.Ys : Y,
      xs, min(Tl::LX, X - xs), [](int) { return PkNoSite{}; },
      [&](int x, const PkQueueLoad<T> (&col)[3], PkNoSite) {
        if (!valid) return;
        const int by = threadIdx.y + PK_H, bz = threadIdx.x + PK_H;
        T acc = T(0);
        acc = pk_pd<T, 0, PK_BOX>(col[0], PK_H, by, bz, 0, 0, 0, w, acc);
        acc = pk_pd<T, 1, PK_BOX>(col[1], PK_H, by, bz, 0, 0, 0, w, acc);
        acc = pk_pd<T, 2, PK_BOX>(col[2], PK_H, by, bz, 0, 0, 0, w, acc);
        div[((int64_t)x * Y + y) * Z + z] = acc;
      });
}

template <typename T, int OP, int PAD>
__global__ void __launch_bounds__(PK_BLOCK_Z * PK_BLOCK_Y)
pk_fd_kernel(const T* __restrict__ in, T* __restrict__ out0,
             T* __restrict__ out1, int64_t C, int X, int Y, int Z,
             PkFdWeights<T> w, PkGeom g) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= Z || y >= Y) return;
  // outputs (blockwise) and the window input, each with its own geometry
  const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
  const int64_t site = ((int64_t)x * Y + y) * Z + z;
  const int64_t Nw = PAD ? g.Nw : N;
  const int Yw = PAD ? g.Ys : Y;
  const int64_t wsite = PAD ? ((int64_t)x * Yw + y) * Z + z : site;

  if (OP == PK_FD_DIV) {
    // in: (n, 3, X, Y, Z) with n = C / 3; out0: (n, X, Y, Z)
    for (int64_t c = 0; c < C / 3; ++c) {
      const T* v = in + 3 * c * Nw;
      T acc = T(0);
      acc = pk_pd<T, 0, PAD>(PkLoad<T>{v, Yw, Z}, x, y, z, X, Y, Z, w.grad,
                             acc);
      acc = pk_pd<T, 1, PAD>(PkLoad<T>{v + Nw, Yw, Z}, x, y, z, X, Y, Z,
                             w.grad, acc);
      acc = pk_pd<T, 2, PAD>(PkLoad<T>{v + 2 * Nw, Yw, Z}, x, y, z, X, Y, Z,
                             w.grad, acc);
      out0[c * N + site] = acc;
    }
    return;
  }

  for (int64_t c = 0; c < C; ++c) {
    const PkLoad<T> load{in + c * Nw, Yw, Z};
    if (OP == PK_FD_LAP) {
      out0[c * N + site] = pk_lap<PAD>(load, in[c * Nw + wsite], x, y, z, X,
                                       Y, Z, w.lap);
    } else if (OP == PK_FD_GRAD || OP == PK_FD_GRAD_LAP) {
      T g3[3];
      pk_grad<PAD>(load, x, y, z, X, Y, Z, w.grad, g3);
#pragma unroll
      for (int d = 0; d < 3; ++d) out0[(3 * c + d) * N + site] = g3[d];
      if (OP == PK_FD_GRAD_LAP)
        out1[c * N + site] = pk_lap<PAD>(load, in[c * Nw + wsite], x, y, z,
                                         X, Y, Z, w.lap);
    } else if (OP == PK_FD_PDX) {
      out0[c * N + site] = pk_pd<T, 0, PAD>(load, x, y, z, X, Y, Z, w.grad,
                                            T(0));
    } else if (OP == PK_FD_PDY) {
      out0[c * N + site] = pk_pd<T, 1, PAD>(load, x, y, z, X, Y, Z, w.grad,
                                            T(0));
    } else {
      out0[c * N + site] = pk_pd<T, 2, PAD>(load, x, y, z, X, Y, Z, w.grad,
                                            T(0));
    }
  }
}

// weights: the Laplacian weights (pk_lap_weights: 1 + 3 * PK_H doubles),
// then the gradient weights (pk_grad_weights: 3 * PK_H). out1 is the
// Laplacian of grad_lap and unused otherwise. g: the sharded tier's
// geometry (PkGeom; unused when PAD is 0).
template <typename T, int OP, int PAD>
static int pk_launch_fd(const void* in, void* out0, void* out1, int64_t C,
                        int X, int Y, int Z, const double* weights,
                        PkGeom g, void* stream) {
  PkFdWeights<T> w;
  w.lap = pk_lap_weights<T>(weights);
  w.grad = pk_grad_weights<T>(weights + PK_NLAPW);
  if constexpr (!PK_FD_PER_SITE && OP != PK_FD_PDX && OP != PK_FD_PDY
                && OP != PK_FD_PDZ) {
    // the marches: components (div: vectors of three) in groups that keep
    // the grid's z extent in range, each group's pointers at its first
    constexpr int LX = OP == PK_FD_LAP        ? PkFdLapTile<T>::LX
                       : OP == PK_FD_GRAD_LAP ? PkFdGradLapTile<T>::LX
                       : OP == PK_FD_GRAD     ? PkFdGradTile<T>::LX
                                              : PkFdDivTile<T>::LX;
    // input arrays and output arrays a marched component has
    constexpr int NIN = OP == PK_FD_DIV ? 3 : 1;
    constexpr int NOUT = OP == PK_FD_GRAD || OP == PK_FD_GRAD_LAP ? 3 : 1;
    using Tl = PkTileGeo;
    const int nruns = (X + LX - 1) / LX;
    const int64_t most = 65535 / nruns;
    const int64_t N = PAD ? g.Nb : (int64_t)X * Y * Z;
    const int64_t Nw = PAD ? g.Nw : N;
    const int64_t nv = C / NIN;
    for (int64_t c0 = 0; c0 < nv; c0 += most) {
      const int nc = (int)(nv - c0 < most ? nv - c0 : most);
      const dim3 grid((Z + Tl::TZ - 1) / Tl::TZ, (Y + Tl::TY - 1) / Tl::TY,
                      nc * nruns);
      const T* src = (const T*)in + NIN * c0 * Nw;
      T* dst = (T*)out0 + NOUT * c0 * N;
      const dim3 block(Tl::TZ, Tl::TY, 1);
      const cudaStream_t s = (cudaStream_t)stream;
      if constexpr (OP == PK_FD_LAP)
        pk_fd_lap_kernel<T, PAD><<<grid, block, 0, s>>>(
            src, dst, X, Y, Z, nruns, w.lap, g);
      else if constexpr (OP == PK_FD_GRAD_LAP)
        pk_fd_grad_lap_kernel<T, PAD><<<grid, block, 0, s>>>(
            src, dst, (T*)out1 + c0 * N, X, Y, Z, nruns, w, g);
      else if constexpr (OP == PK_FD_GRAD)
        pk_fd_grad_kernel<T, PAD><<<grid, block, 0, s>>>(
            src, dst, X, Y, Z, nruns, w.grad, g);
      else
        pk_fd_div_kernel<T, PAD><<<grid, block, 0, s>>>(
            src, dst, X, Y, Z, nruns, w.grad, g);
      const int err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
    return 0;
  } else {
    pk_fd_kernel<T, OP, PAD>
        <<<pk_grid(X, Y, Z), dim3(PK_BLOCK_Z, PK_BLOCK_Y, 1), 0,
           (cudaStream_t)stream>>>((const T*)in, (T*)out0, (T*)out1, C, X,
                                   Y, Z, w, g);
    return (int)cudaGetLastError();
  }
}

#define PK_FD_ARGS                                                          \
  const void *in, void *out0, void *out1, int64_t C, int X, int Y, int Z,   \
      const double *weights
#define PK_FD_ENTRY(name, T, OP)                                            \
  extern "C" int name(PK_FD_ARGS, void* stream) {                           \
    return pk_launch_fd<T, OP, 0>(in, out0, out1, C, X, Y, Z, weights,      \
                                  PkGeom{0, 0, 0}, stream);                 \
  }
// the sharded tier: windows padded along x, y or both (interior and shell
// launches take the x-padded entry point)
#define PK_FD_PAD_ENTRY(name, T, OP, PAD)                                   \
  extern "C" int name(PK_FD_ARGS, int64_t Nb, int64_t Nw, int Ys,          \
                      void* stream) {                                       \
    return pk_launch_fd<T, OP, PAD>(in, out0, out1, C, X, Y, Z, weights,    \
                                    PkGeom{Nb, Nw, Ys}, stream);            \
  }
#define PK_FD_TYPED(op, OP, suffix, T)                                      \
  PK_FD_ENTRY(pk_fd_##op##_##suffix, T, OP)                                 \
  PK_FD_PAD_ENTRY(pk_fd_##op##_##suffix##_xpad, T, OP, PK_PAD_X)            \
  PK_FD_PAD_ENTRY(pk_fd_##op##_##suffix##_ypad, T, OP, PK_PAD_Y)            \
  PK_FD_PAD_ENTRY(pk_fd_##op##_##suffix##_xypad, T, OP,                     \
                  PK_PAD_X | PK_PAD_Y)
#define PK_FD_ENTRIES(op, OP)                                               \
  PK_FD_TYPED(op, OP, f32, float)                                           \
  PK_FD_TYPED(op, OP, f64, double)

// The Laplacian's march tile for float (f64 = 0) or double (f64 = 1): out
// = {x planes a run, static shared memory a block in bytes}. Returns 0.
extern "C" int pk_fd_lap_tile(int f64, int* out) {
  out[0] = PK_FD_PER_SITE ? 0 : PkFdLapTile<float>::LX;
  out[1] = f64 ? PkFdLapTile<double>::SMEM : PkFdLapTile<float>::SMEM;
  return 0;
}

// A queue march's tile in the same form, then 1 if its loads go a step
// ahead. x planes 0: a per-site build (PK_FD_PER_SITE).
template <template <typename> class Tile>
static int pk_fd_queue_tile(int f64, int ahead, int* out) {
  out[0] = PK_FD_PER_SITE ? 0 : Tile<float>::LX;
  out[1] = f64 ? Tile<double>::SMEM : Tile<float>::SMEM;
  out[2] = ahead;
  return 0;
}

// grad_lap's, grad's and div's
extern "C" int pk_fd_grad_lap_tile(int f64, int* out) {
  return pk_fd_queue_tile<PkFdGradLapTile>(f64, PK_FD_GRAD_LAP_AHEAD, out);
}

extern "C" int pk_fd_grad_tile(int f64, int* out) {
  return pk_fd_queue_tile<PkFdGradTile>(f64, PK_FD_GRAD_AHEAD, out);
}

extern "C" int pk_fd_div_tile(int f64, int* out) {
  return pk_fd_queue_tile<PkFdDivTile>(f64, PK_FD_DIV_AHEAD, out);
}

PK_FD_ENTRIES(lap, PK_FD_LAP)
PK_FD_ENTRIES(grad, PK_FD_GRAD)
PK_FD_ENTRIES(grad_lap, PK_FD_GRAD_LAP)
PK_FD_ENTRIES(pdx, PK_FD_PDX)
PK_FD_ENTRIES(pdy, PK_FD_PDY)
PK_FD_ENTRIES(pdz, PK_FD_PDZ)
PK_FD_ENTRIES(div, PK_FD_DIV)
