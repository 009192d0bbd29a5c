"""Multi-device parallelism over the hp-decomposition's element axis.

The reference is single-process CPU (sessions pinned at Poisson-1D.py:105);
its *semantic* parallel axis is the element sum of the variational loss
(Poisson-1D.py:64-96): elements couple only through the shared MLP weights and
the summed loss.  That axis maps onto a device mesh:

  * element-indexed arrays (everything in `data["elements"]`, leading axis E)
    are laid out with `NamedSharding(mesh, P("elements"))`;
  * parameters and basis tensors are replicated (`P()`) — the networks are
    tiny ([2,5,5,5,1] .. [1,20x4,1]), so no parameter sharding is warranted;
  * the only communication the math needs is the all-reduce of per-element
    loss/grad contributions, which XLA inserts automatically for the GSPMD
    path (jit over sharded operands) or which `psum` provides explicitly in
    the `shard_map` path.  On a multi-GPU host XLA lowers it to an NCCL
    all-reduce over NVLink.

Both paths are provided: GSPMD (annotate + let XLA partition — the default
used by the trainer) and an explicit `shard_map` formulation (manual control,
used by tests and the multichip dry run to prove the collective layout).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "elements"
POINT_AXIS = "points"


def element_mesh(devices: Optional[Sequence] = None, axis_name: str = AXIS) -> Mesh:
    """1D device mesh over the element axis."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def element_point_mesh(
    shape: tuple,
    devices: Optional[Sequence] = None,
    axis_names: tuple = (AXIS, POINT_AXIS),
) -> Mesh:
    """2D mesh: elements x quadrature-points — the data-parallel x
    sequence-parallel analog for this workload.  The point axis splits the
    fast quadrature dimension; the contraction over it becomes partial sums
    + an all-reduce that XLA inserts (GSPMD) or `psum` provides (shard_map).
    """
    devices = list(devices) if devices is not None else jax.devices()
    n = shape[0] * shape[1]
    return Mesh(np.asarray(devices[:n]).reshape(shape), axis_names)


def _pad_leading(arr: jax.Array, pad: int, *, zero: bool) -> jax.Array:
    """Pad axis 0 by `pad` rows; edge-replicate (safe network inputs) or zero."""
    if pad == 0:
        return arr
    mode = "constant" if zero else "edge"
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return jax.numpy.asarray(np.pad(np.asarray(arr), widths, mode=mode))


def pad_elements(elems, multiple: int):
    """Pad an Elements1D/2D batch so E divides the mesh size.

    Padded elements are inert: mask = 0 and f_proj = 0 (their residual
    contributes exactly zero to the loss), n_test = 1 (no division by zero),
    geometry edge-replicated (network evaluations stay finite).
    """
    E = elems.mask.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return elems
    fields = {}
    for f in dataclasses.fields(elems):
        arr = getattr(elems, f.name)
        if f.name in ("mask", "f_proj"):
            fields[f.name] = _pad_leading(arr, pad, zero=True)
        elif f.name == "n_test":
            fields[f.name] = _pad_leading(jax.numpy.maximum(arr, 1), pad, zero=False)
        else:
            fields[f.name] = _pad_leading(arr, pad, zero=False)
    return type(elems)(**fields)


def _pad_trailing(arr: jax.Array, pad: int, *, zero: bool) -> jax.Array:
    """Pad the LAST axis by `pad`; edge-replicate or zero."""
    if pad == 0:
        return arr
    mode = "constant" if zero else "edge"
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
    return jax.numpy.asarray(np.pad(np.asarray(arr), widths, mode=mode))


def pad_points(elems, fast_basis, multiple: int):
    """Pad the fast quadrature axis (last axis of x/y and the column axis of
    the fast-axis weighted basis) so Q divides the point-axis size.

    Padded quadrature points are inert: the basis columns there carry zero
    quadrature weight, so they contribute exactly zero to every contraction;
    the coordinates are edge-replicated (finite network inputs).
    """
    Q = elems.x.shape[-1]
    pad = (-Q) % multiple
    if pad == 0:
        return elems, fast_basis
    efields = {}
    for f in dataclasses.fields(elems):
        arr = getattr(elems, f.name)
        if f.name in ("x", "y", "z"):
            efields[f.name] = _pad_trailing(arr, pad, zero=False)
        else:
            efields[f.name] = arr
    bfields = {}
    for f in dataclasses.fields(fast_basis):
        arr = getattr(fast_basis, f.name)
        if f.name in ("wphi", "wdphi", "wd2phi"):
            bfields[f.name] = _pad_trailing(arr, pad, zero=True)
        else:
            bfields[f.name] = arr
    return type(elems)(**efields), type(fast_basis)(**bfields)


def shard_problem(
    data: dict, mesh: Mesh, axis_name: str = AXIS, point_axis: Optional[str] = None
) -> dict:
    """Lay out a problem's data pytree on the mesh: element arrays split on
    axis 0, everything else replicated.  Pads the element batch as needed.

    If `point_axis` names a second mesh axis, the fast quadrature dimension
    (last axis of the element coordinates, column axis of the fast-axis
    basis) is split over it as well — the contraction over quadrature points
    then all-reduces partial sums over that axis (XLA inserts it).
    """
    if point_axis is None and POINT_AXIS in mesh.axis_names:
        point_axis = POINT_AXIS
    rep_sharding = NamedSharding(mesh, P())
    n_elem_shards = mesh.shape[axis_name]
    out = dict(data)

    elems = pad_elements(data["elements"], n_elem_shards)
    fast_key = "basis_x" if "basis_x" in data else "basis"
    if point_axis is not None:
        elems, fast_basis = pad_points(elems, data[fast_key], mesh.shape[point_axis])
        out[fast_key] = fast_basis

    def elem_spec(name, arr):
        lead = (axis_name,) + (None,) * (arr.ndim - 1)
        spec = list(lead)
        if point_axis is not None and name in ("x", "y", "z"):
            spec[-1] = point_axis
        return P(*spec)

    efields = {
        f.name: jax.device_put(
            getattr(elems, f.name), NamedSharding(mesh, elem_spec(f.name, getattr(elems, f.name)))
        )
        for f in dataclasses.fields(elems)
    }
    out["elements"] = type(elems)(**efields)

    for key in out:
        if key == "elements":
            continue
        value = out[key]
        if point_axis is not None and key == fast_key:
            bfields = {}
            for f in dataclasses.fields(value):
                arr = getattr(value, f.name)
                spec = P(None, point_axis) if f.name in ("wphi", "wdphi", "wd2phi") else P()
                bfields[f.name] = jax.device_put(arr, NamedSharding(mesh, spec))
            out[key] = type(value)(**bfields)
        else:
            out[key] = jax.device_put(value, rep_sharding)
    return out


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Replicate a pytree (parameters, optimizer state) across the mesh."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


def shard_map_loss(loss_fn, data: dict, mesh: Mesh, axis_name: str = AXIS):
    """Explicit shard_map formulation of a problem loss.

    `loss_fn` must accept `axis_name=` and psum its element-sum terms over it
    (all problem losses in problems/ do).  Returns a (params, data) -> (loss,
    aux) function where every output is replicated — differentiable through
    shard_map, so jax.grad of it yields replicated gradients.
    """

    def spec_like(key, value):
        part = P(axis_name) if key == "elements" else P()
        return jax.tree.map(lambda _: part, value)

    data_specs = {k: spec_like(k, v) for k, v in data.items()}

    def wrapped(params, data):
        pspec = jax.tree.map(lambda _: P(), params)

        def local(params, data):
            return loss_fn(params, data, axis_name=axis_name)

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(pspec, data_specs),
            out_specs=(P(), jax.tree.map(lambda _: P(), _aux_structure(loss_fn, params, data))),
            check_vma=False,
        )(params, data)

    return wrapped


def _aux_structure(loss_fn, params, data):
    """Aux pytree structure via abstract evaluation (no FLOPs)."""
    return jax.eval_shape(lambda p, d: loss_fn(p, d)[1], params, data)
