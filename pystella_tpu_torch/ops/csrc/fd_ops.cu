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
// site and component. Design: one thread per site, z fastest, so the
// centre loads and every store are coalesced; the 6h neighbour taps are
// re-read through L1/L2; periodic wrap by index arithmetic on all three
// axes, so any lattice shape runs; the components are a loop inside the
// thread (the wrapped neighbour indices do not depend on the component),
// with 64-bit offsets (C * 512^3 passes 2^31 at C = 16). grad writes (C, 3, X,
// Y, Z), div reads (n, 3, X, Y, Z). Built with -fmad=false: no multiply-add
// is contracted where the plain PyTorch version rounds twice.
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
// acc + w * (tap(+s) - tap(-s)).
template <typename T, int AXIS, int PAD, typename Load>
__device__ __forceinline__ T pk_pd(const Load& load, int x, int y, int z,
                                   int X, int Y, int Z,
                                   const PkGradWeights<T>& w, T acc) {
  constexpr bool PX = PAD & PK_PAD_X, PY = PAD & PK_PAD_Y;
#pragma unroll
  for (int s = 1; s <= PK_H; ++s) {
    if (AXIS == 0)
      acc = acc + w.wx[s - 1] * (load(pk_tap<PX>(x + s, X), y, z)
                                 - load(pk_tap<PX>(x - s, X), y, z));
    else if (AXIS == 1)
      acc = acc + w.wy[s - 1] * (load(x, pk_tap<PY>(y + s, Y), z)
                                 - load(x, pk_tap<PY>(y - s, Y), z));
    else
      acc = acc + w.wz[s - 1] * (load(x, y, pk_wrap(z + s, Z))
                                 - load(x, y, pk_wrap(z - s, Z)));
  }
  return acc;
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
  pk_fd_kernel<T, OP, PAD>
      <<<pk_grid(X, Y, Z), dim3(PK_BLOCK_Z, PK_BLOCK_Y, 1), 0,
         (cudaStream_t)stream>>>((const T*)in, (T*)out0, (T*)out1, C, X, Y,
                                 Z, w, g);
  return (int)cudaGetLastError();
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

PK_FD_ENTRIES(lap, PK_FD_LAP)
PK_FD_ENTRIES(grad, PK_FD_GRAD)
PK_FD_ENTRIES(grad_lap, PK_FD_GRAD_LAP)
PK_FD_ENTRIES(pdx, PK_FD_PDX)
PK_FD_ENTRIES(pdy, PK_FD_PDY)
PK_FD_ENTRIES(pdz, PK_FD_PDZ)
PK_FD_ENTRIES(div, PK_FD_DIV)
