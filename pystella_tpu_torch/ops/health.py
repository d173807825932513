"""The numerics sentinel's field statistics, on CUDA: max|x| and the mean
of x**2 of each field of a state, in one read.

The JAX package computes them in ``Sentinel.compute`` as one variadic
reduction per field (``_max_abs_and_mean_sq``,
pystella_tpu/obs/sentinel.py:79-99), which XLA fuses into one read of the
state; it has no Pallas kernel there. In PyTorch the plain version takes
several passes a field, so on a CUDA tensor the port runs a hand-written
kernel (``ops/csrc/health.cu``):

- **K15** ``health``: one block a unit (one x-plane times
  :func:`~pystella_tpu_torch.ops.histogram.unit_rows` y-rows, K13's units),
  one warp a z-row; per unit the NaN-propagating max of |x| and the float64
  sum of the squares (each formed in the field's dtype, as ``jnp.square``),
  written as partials at the unit's global index;
- ``health_finish``: the one launch that reduces every field's partials in
  a fixed order and writes the health vector's field slots ``finite``,
  ``max_abs`` and ``rms`` (:data:`FIELD_STATS`).

For an ensemble batch (:func:`field_stats_members`: each field a
``(members, ...)`` tensor or :class:`~pystella_tpu_torch.parallel.ShardedArray`
whose blocks lead with the member axis) K15 reads each field once for the
whole batch, the member axis folded into its outer rows, so member ``m``'s
units are one contiguous run of the partials; the finish then reduces one
segment a member and field (at most :data:`MAX_FIELDS` segments a launch)
in the order a lone member's finish does, so row ``m`` of the matrix equals
:func:`field_stats` of member ``m`` bit for bit. These launches count as
``health:members`` and ``health_finish:members``.

A :class:`~pystella_tpu_torch.parallel.ShardedArray`'s blocks write their
units at their global places, so a sharded state gives the single-device
vector bit for bit (each block's y-extent must hold whole units, as for
K13). Beside the kernel is its plain version: ``amax`` and a float64
``sum`` along z, the row partials placed at their global ``(x, y)`` and
reduced once (so it too gives a sharded state's vector bit for bit). A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The two agree exactly in ``finite`` and ``max_abs`` and to rounding
in ``rms`` (the float64 additions run in another order).
"""

from __future__ import annotations

import ctypes

import torch

from pystella_tpu_torch.ops import stencil as _stencil
from pystella_tpu_torch.ops.histogram import unit_rows
from pystella_tpu_torch.parallel.decomp import ShardedArray

__all__ = ["FIELD_STATS", "KERNELS", "LAUNCHES", "reset_launch_counts",
           "build_kernels", "bind_kernels", "field_stats",
           "field_stats_plain", "field_stats_members",
           "field_stats_members_plain", "field_layout", "MAX_FIELDS"]

#: per-field statistics, in slot order (the JAX sentinel's FIELD_STATS)
FIELD_STATS = ("finite", "max_abs", "rms")

_SOURCE = "health.cu"
#: kernel name -> (CUDA source in ops/csrc, the JAX site it serves; the JAX
#: package has no Pallas kernel there)
KERNELS = {
    "health": (_SOURCE, "pystella_tpu/obs/sentinel.py:79 "
                        "(_max_abs_and_mean_sq: one variadic lax.reduce a "
                        "field; no Pallas kernel)"),
    "health_finish": (_SOURCE, "pystella_tpu/obs/sentinel.py:180 "
                               "(Sentinel.compute: the finite flag, max_abs "
                               "and sqrt(mean_sq) a field; no Pallas "
                               "kernel)"),
    "health:members": (_SOURCE, "pystella_tpu/obs/sentinel.py:204 "
                                "(Sentinel.compute_members: a vmap of the "
                                "variadic reductions; no Pallas kernel)"),
    "health_finish:members": (_SOURCE, "pystella_tpu/obs/sentinel.py:204 "
                                       "(Sentinel.compute_members; no "
                                       "Pallas kernel)"),
}
#: kernel name -> number of launches since the last reset; the wrapper adds
#: one where it launches the kernel, and nowhere else
LAUNCHES = {name: 0 for name in KERNELS}
#: fields one finish launch takes (health.cu: PK_HEALTH_MAX_FIELDS)
MAX_FIELDS = 32
#: the dtypes the kernel reads
DTYPES = {torch.float32: "f32", torch.float64: "f64",
          torch.bfloat16: "bf16"}

#: the generated header health.cu is compiled against (through
#: pk_common.cuh): no model and no stencil, so a radius of 1 for the
#: shared header's declarations
_HEADER = ("// Generated by pystella_tpu_torch.ops.health; do not edit.\n"
           "#pragma once\n#define PK_H 1\n")
_LIB = {}
_SM_COUNT = {}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def bind_kernels(lib):
    """The entry points of a loaded health library, typed: ``{name: C
    function}``."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    main = [vp, vp, vp, i64] + [i32] * 8 + [i64, i32, vp]
    P = ctypes.POINTER
    finish = [vp, vp, i32, P(i64), P(i64), P(ctypes.c_double), P(i32), vp,
              vp]
    fns = {}
    for name, args in (("pk_health_f32", main), ("pk_health_f64", main),
                       ("pk_health_bf16", main),
                       ("pk_health_finish_f32", finish),
                       ("pk_health_finish_f64", finish),
                       ("pk_health_max_fields", [])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
        fns[name] = fn
    return fns


def build_kernels():
    """Compile (or load from the build cache) ``health.cu`` and bind its
    entry points; raises if ``nvcc`` fails or the library's field limit is
    not :data:`MAX_FIELDS`."""
    if not _LIB:
        fns = bind_kernels(_stencil.build_kernels([_SOURCE], _HEADER)[_SOURCE])
        if fns["pk_health_max_fields"]() != MAX_FIELDS:
            raise RuntimeError("health.cu takes another number of fields "
                               "a finish than ops/health.py:MAX_FIELDS")
        _LIB.update(fns)
    return _LIB


def _check(rc, name):
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _lattice(shape):
    """``(nouter, X, Y, Z)`` of a field's shape: the last three axes are
    the lattice (a field of fewer axes has leading lattice extents 1), the
    rest the outer axes."""
    shape = tuple(int(n) for n in shape)
    lat = (1,) * max(0, 3 - len(shape)) + shape[-3:]
    nouter = 1
    for n in shape[:-3]:
        nouter *= n
    return (nouter,) + lat


def field_layout(x):
    """The rows of one field (a tensor or a :class:`ShardedArray`):
    ``((nouter, X, Y, Z), [(block as (nouter, bx, by, Z), x0, y0), ...])``
    with each block's global lattice origin."""
    if isinstance(x, ShardedArray):
        d = x.decomp
        if d.proc_shape[2] > 1:
            raise ValueError("the health statistics take meshes that shard "
                             "x and y only: a row keeps z whole")
        blocks = []
        for r, b in enumerate(x.blocks):
            n, bx, by, Z = _lattice(b.shape)
            cx, cy = d.coords(r)[:2]
            blocks.append((b.reshape(n, bx, by, Z), cx * bx, cy * by))
        return _lattice(x.shape), blocks
    x = torch.as_tensor(x)
    g = _lattice(x.shape)
    return g, [(x.reshape(g), 0, 0)]


def _on_card(layouts):
    types = {b.device.type for _, blocks in layouts for b, _, _ in blocks}
    if len(types) != 1:
        raise ValueError("the fields lie on CPU and CUDA devices at once")
    return types.pop() == "cuda"


def _sm_count(dev):
    """The card's SMs (a launch takes at most 16 blocks an SM and strides
    over the rest; one on the CPU stand-in, where that stride is what a
    rehearsal exercises)."""
    if dev.type != "cuda":
        return 1
    n = _SM_COUNT.get(dev)
    if n is None:
        n = _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _vector(maxes, sums, counts, dtype):
    """The field slots from per-field float64 maxima and sums: the finite
    flag, max_abs and sqrt(sum / count), the division through a 0-d float64
    tensor (PyTorch's CUDA division by a Python number multiplies by the
    reciprocal)."""
    parts = []
    for m, s, n in zip(maxes, sums, counts):
        mean = s / torch.tensor(float(n), dtype=torch.float64,
                                device=s.device)
        finite = torch.isfinite(m) & ~torch.isnan(mean)
        parts += [finite.to(torch.float64), m, torch.sqrt(mean)]
    return torch.stack(parts).to(dtype)


def field_stats_plain(fields, dtype=torch.float32):
    """K15's plain version on any device: the ``3 * len(fields)`` field
    slots of the health vector (per field ``finite``, ``max_abs``,
    ``rms``) in ``dtype``, on the first field's device. Per block the row
    partials ``amax(|x|)`` and the float64 ``sum`` of ``x * x`` (formed in
    the field's dtype) along z, placed at their global rows and reduced
    once."""
    maxes, sums, counts = [], [], []
    dev = None
    for x in fields:
        (n, X, Y, Z), blocks = field_layout(x)
        if dev is None:
            dev = blocks[0][0].device
        pm = torch.empty((n, X, Y), dtype=torch.float64, device=dev)
        ps = torch.empty((n, X, Y), dtype=torch.float64, device=dev)
        for b, x0, y0 in blocks:
            bx, by = b.shape[1], b.shape[2]
            pm[:, x0:x0 + bx, y0:y0 + by] = torch.amax(
                torch.abs(b), dim=-1).to(torch.float64).to(dev)
            ps[:, x0:x0 + bx, y0:y0 + by] = torch.sum(
                (b * b).to(torch.float64), dim=-1).to(dev)
        maxes.append(torch.amax(pm))
        sums.append(torch.sum(ps))
        counts.append(n * X * Y * Z)
    return _vector(maxes, sums, counts, dtype)


def _check_members(layouts, members):
    """Raise unless every field's outer rows split evenly into
    ``members``."""
    for (n, _, _, _), _ in layouts:
        if n % members:
            raise ValueError(f"a field of {n} outer rows does not hold "
                             f"{members} members")


def field_stats_members_plain(fields, members, dtype=torch.float32):
    """The plain version of :func:`field_stats_members`: the row partials
    of every field once for the batch (as :func:`field_stats_plain` forms
    them), then per member the reduction of its rows, each from a tensor
    of its own (so row ``m`` is :func:`field_stats_plain` of member ``m``
    bit for bit)."""
    layouts = [field_layout(x) for x in fields]
    _check_members(layouts, members)
    partials, dev = [], None
    for (n, X, Y, Z), blocks in layouts:
        if dev is None:
            dev = blocks[0][0].device
        pm = torch.empty((n, X, Y), dtype=torch.float64, device=dev)
        ps = torch.empty((n, X, Y), dtype=torch.float64, device=dev)
        for b, x0, y0 in blocks:
            bx, by = b.shape[1], b.shape[2]
            pm[:, x0:x0 + bx, y0:y0 + by] = torch.amax(
                torch.abs(b), dim=-1).to(torch.float64).to(dev)
            ps[:, x0:x0 + bx, y0:y0 + by] = torch.sum(
                (b * b).to(torch.float64), dim=-1).to(dev)
        partials.append((pm, ps, n // members * X * Y * Z, n // members))
    rows = []
    for m in range(members):
        maxes, sums, counts = [], [], []
        for pm, ps, count, k in partials:
            maxes.append(torch.amax(pm[m * k:(m + 1) * k].clone()))
            sums.append(torch.sum(ps[m * k:(m + 1) * k].clone()))
            counts.append(count)
        rows.append(_vector(maxes, sums, counts, dtype))
    return torch.stack(rows)


def field_stats_members(fields, members, dtype=torch.float32):
    """The field slots of every member's health vector, a ``(members, 3 *
    len(fields))`` matrix in ``dtype`` on the first field's device, from
    ONE read of each field: ``fields`` are batches (tensors ``(members,
    ...)``, or :class:`ShardedArray` s whose blocks lead with the member
    axis). On the card one K15 launch a block of a field over the whole
    batch, then one finish launch a group of at most :data:`MAX_FIELDS`
    (member, field) segments; no host sync. Row ``m`` equals
    :func:`field_stats` of member ``m`` bit for bit. CPU tensors take
    :func:`field_stats_members_plain`."""
    members = int(members)
    layouts = [field_layout(x) for x in fields]
    if not layouts or members < 1:
        raise ValueError("field_stats_members needs a field and a member")
    if not _on_card(layouts):
        return field_stats_members_plain(fields, members, dtype)
    _check_members(layouts, members)
    dev, fns, units, offs, pmax, psum = _read_fields(layouts,
                                                     "health:members")
    K = len(layouts)
    odt = dtype if dtype in (torch.float32, torch.float64) else torch.float64
    out = torch.empty((members, 3 * K), dtype=odt, device=dev)
    segs = [(offs[k] + m * (units[k] // members), units[k] // members,
             float(g[0] // members * g[1] * g[2] * g[3]), 3 * (m * K + k))
            for m in range(members)
            for k, (g, _) in enumerate(layouts)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i in range(0, len(segs), MAX_FIELDS):
            _finish(fns, odt, pmax, psum, segs[i:i + MAX_FIELDS], out,
                    stream, "health_finish:members")
    return out if odt == dtype else out.to(dtype)


def _read_fields(layouts, label):
    """K15 over every block of every field into fresh partials (one
    launch a block, counted under ``label``): ``(device, entry points,
    units a field, first unit a field, pmax, psum)``."""
    dev = layouts[0][1][0][0].device
    for _, blocks in layouts:
        for b, _, _ in blocks:
            if b.device != dev:
                raise NotImplementedError(
                    "the health kernel takes blocks on one card; these lie "
                    f"on {b.device} and {dev}")
            if b.dtype not in DTYPES:
                raise TypeError(f"the health kernel reads float32, float64 "
                                f"and bfloat16 fields; got {b.dtype}")
    fns = build_kernels()
    rys = [unit_rows(Y) for (_, _, Y, _), _ in layouts]
    for ry, (_, blocks) in zip(rys, layouts):
        for b, _, _ in blocks:
            if b.shape[2] % ry:
                raise ValueError(
                    f"a block of y-extent {b.shape[2]} does not hold whole "
                    f"units of {ry} rows; the health kernel needs each "
                    "block's y-extent to be a multiple of unit_rows(Y)")
    units = [n * X * (Y // ry) for ((n, X, Y, _), _), ry in zip(layouts,
                                                                rys)]
    offs = [sum(units[:k]) for k in range(len(units))]
    pmax = torch.empty(sum(units), dtype=torch.float64, device=dev)
    psum = torch.empty(sum(units), dtype=torch.float64, device=dev)
    nsm = _sm_count(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for ((n, X, Y, Z), blocks), off, ry in zip(layouts, offs, rys):
            for b, x0, y0 in blocks:
                b = b.contiguous()
                entry = fns["pk_health_" + DTYPES[b.dtype]]
                _check(entry(b.data_ptr(), pmax.data_ptr(), psum.data_ptr(),
                             b.shape[0] * b.shape[1] * (b.shape[2] // ry),
                             ry, b.shape[1], b.shape[2], Z, X, Y, x0, y0,
                             off, nsm, stream), label)
                LAUNCHES[label] += 1
    return dev, fns, units, offs, pmax, psum


def _finish(fns, odt, pmax, psum, segs, out, stream, label):
    """One finish launch over ``segs``, ``(first unit, units, element
    count, first slot of out)`` each, of the partials ``pmax`` and
    ``psum``, counted under ``label``."""
    k = len(segs)
    arr = (lambda t, v: (t * k)(*v))
    _check(fns["pk_health_finish_" + ("f32" if odt == torch.float32
                                      else "f64")](
        pmax.data_ptr(), psum.data_ptr(), k,
        arr(ctypes.c_int64, [g[0] for g in segs]),
        arr(ctypes.c_int64, [g[1] for g in segs]),
        arr(ctypes.c_double, [g[2] for g in segs]),
        arr(ctypes.c_int, [g[3] for g in segs]), out.data_ptr(), stream),
        label)
    LAUNCHES[label] += 1


def field_stats(fields, dtype=torch.float32):
    """The health vector's field slots of ``fields`` (tensors or
    :class:`ShardedArray` s, each ``(..., X, Y, Z)``; float32, float64 or
    bfloat16 on the card): ``3 * len(fields)`` values, per field
    ``finite``, ``max_abs``, ``rms``, in ``dtype`` on the first field's
    device. K15 on CUDA tensors (one launch a block of a field, then one
    finish launch), no host sync; the plain version on CPU tensors."""
    layouts = [field_layout(x) for x in fields]
    if not layouts:
        raise ValueError("field_stats needs at least one field")
    if not _on_card(layouts):
        return field_stats_plain(fields, dtype)
    if len(layouts) > MAX_FIELDS:
        raise ValueError(f"{len(layouts)} fields: one health finish takes "
                         f"at most {MAX_FIELDS}")
    dev, fns, units, offs, pmax, psum = _read_fields(layouts, "health")
    odt = dtype if dtype in (torch.float32, torch.float64) else torch.float64
    out = torch.empty(3 * len(layouts), dtype=odt, device=dev)
    segs = [(offs[k], units[k], float(g[0] * g[1] * g[2] * g[3]), 3 * k)
            for k, (g, _) in enumerate(layouts)]
    with torch.cuda.device(dev):
        _finish(fns, odt, pmax, psum, segs, out,
                torch.cuda.current_stream(dev).cuda_stream, "health_finish")
    return out if odt == dtype else out.to(dtype)
