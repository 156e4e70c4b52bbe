"""Device mesh construction and multi-host bring-up.

The reference has no distributed components (SURVEY.md §2.6); this layer is
the scale-out subsystem: a 2-D
``('data', 'frame')`` mesh where utterance batches are data-parallel across the
``data`` axis and long-form audio is frame-sharded across the ``frame`` axis
(halo exchange in parallel/sharded.py). XLA lowers the collectives to NCCL
on GPUs; the cards of one host are joined all to all by NVLink, so the mesh
follows the algorithm, not a physical topology.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
FRAME_AXIS = "frame"


def make_mesh(data: Optional[int] = None, frame: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ``(data, frame)`` mesh over ``devices`` (default: all devices).

    ``data=None`` uses every device not consumed by the ``frame`` axis.
    The frame axis is placed innermost (fastest-varying), so halo
    ``ppermute`` neighbors are consecutive devices.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if frame <= 0 or n % frame != 0:
        raise ValueError(f"frame axis size {frame} must divide device count {n}")
    if data is None:
        data = n // frame
    if data * frame > n:
        raise ValueError(f"mesh {data}x{frame} needs {data * frame} devices, have {n}")
    dev_array = np.asarray(devices[: data * frame]).reshape(data, frame)
    return Mesh(dev_array, (DATA_AXIS, FRAME_AXIS))


def single_device_mesh() -> Mesh:
    """1x1 mesh on the default device (useful to run sharded code paths
    unchanged on one chip)."""
    return make_mesh(data=1, frame=1, devices=jax.devices()[:1])


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a batch-leading array: batch split over 'data', replicated
    over 'frame'."""
    return NamedSharding(mesh, P(DATA_AXIS))


def batch_frame_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for [batch, time/frames, ...]: batch over 'data', second axis
    over 'frame'."""
    return NamedSharding(mesh, P(DATA_AXIS, FRAME_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def host_to_global(arr, mesh: Mesh, spec: P) -> jax.Array:
    """Turn a host array into a global ``jax.Array`` with
    ``NamedSharding(mesh, spec)``, working on REAL multi-process meshes.

    Single process: plain ``jax.device_put``. Multi-process: every process
    must hold an identical full host copy (replicated-input model — e.g.
    each process read the same file); each process contributes only the
    shards its local devices own via ``make_array_from_callback``, so no
    process ever device_puts data for a non-addressable device (the failure
    mode of host-global ``jax.device_put`` on a multi-process mesh).
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def data_group_for_process(mesh: Mesh, axis: str = DATA_AXIS
                           ) -> tuple[int, int]:
    """(group_index, num_groups) for the process-local ingest.

    Processes whose devices own the SAME set of ``axis`` coordinates form an
    ingest GROUP: each group supplies its own rows (identical within the
    group — e.g. the same file list, io.dataset.shard_files_for_group) and
    the global batch is the concatenation of the groups in coordinate order.
    On the usual layouts each process owns distinct coordinates and every
    group has one member (group_index == process_index); on a mesh whose
    OTHER axis also spans processes — e.g. a 2x2 ``(data, frame)`` mesh over
    four single-device processes — two processes co-own each data block and
    form a two-member group.

    Raises when the layout is not groupable: coordinate sets must partition
    ``[0, n_axis)`` into equal-size CONTIGUOUS blocks (so each group's rows
    map to one contiguous global slice).
    """
    n_axis = mesh.shape[axis]
    if jax.process_count() == 1:
        return 0, 1
    axis_idx = list(mesh.axis_names).index(axis)
    devs = np.moveaxis(mesh.devices, axis_idx, 0)
    coords_by_proc: dict[int, set[int]] = {}
    for c in range(n_axis):
        for d in devs[c].flat:
            coords_by_proc.setdefault(d.process_index, set()).add(c)
    my = coords_by_proc.get(jax.process_index())
    if my is None:
        raise ValueError(
            f"process {jax.process_index()} owns no device in the mesh")
    keys = sorted({tuple(sorted(s)) for s in coords_by_proc.values()})
    size = len(keys[0])
    flat = [c for k in keys for c in k]
    if (any(len(k) != size for k in keys)
            or flat != list(range(n_axis))
            or any(k != tuple(range(k[0], k[0] + size)) for k in keys)):
        raise ValueError(
            f"'{axis}' axis coordinates {keys} do not partition into "
            "equal contiguous per-group blocks; use the replicated-input "
            "model (host_to_global)")
    return keys.index(tuple(sorted(my))), len(keys)


def local_rows_to_global(local_rows, mesh: Mesh, spec: P) -> jax.Array:
    """Assemble a global batch from each process's OWN leading-axis rows
    (process-local-input model — the DP ingest path fed by
    ``io.dataset.shard_files_for_process`` / ``shard_files_for_group``).

    Single process: plain ``jax.device_put`` (the rows are the batch).
    Multi-process, one process per data block: ``jax.make_array_from_
    process_local_data`` concatenates the per-process rows along the leading
    axis in process order. When several processes co-own each data block
    (``data_group_for_process``), rows are placed per-group instead: each
    addressable device gets the slice of this group's rows its global index
    selects (group members must pass identical rows). Every process must
    pass the same local row count (SPMD: the compiled program and therefore
    the global shape must be identical everywhere).
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local_rows, sharding)
    local = np.ascontiguousarray(local_rows)
    axis = spec[0] if len(spec) else DATA_AXIS
    gi, ng = data_group_for_process(mesh, axis)
    if ng == jax.process_count():
        return jax.make_array_from_process_local_data(sharding, local)
    global_shape = (local.shape[0] * ng,) + local.shape[1:]
    off = gi * local.shape[0]
    arrays = []
    for dev, idx in sharding.addressable_devices_indices_map(
            global_shape).items():
        r0 = idx[0].start or 0
        r1 = global_shape[0] if idx[0].stop is None else idx[0].stop
        if r0 < off or r1 > off + local.shape[0]:
            raise ValueError(
                f"device {dev} needs global rows [{r0}, {r1}) outside this "
                f"process's group block [{off}, {off + local.shape[0]})")
        sub = local[r0 - off: r1 - off]
        arrays.append(jax.device_put(sub[(slice(None),) + idx[1:]], dev))
    return jax.make_array_from_single_device_arrays(global_shape, sharding,
                                                    arrays)


def process_local_batch_multiple(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    """Rows-per-process granularity for ``local_rows_to_global``: each
    process's local batch must pad to a multiple of the ``axis`` positions
    its ingest GROUP owns, so every device gets whole rows.

    With the process-ordered device layout ``make_mesh`` builds (jax.devices()
    enumerates process 0's devices first), each group owns
    ``axis_size / num_groups`` consecutive positions (usually one group per
    process; see :func:`data_group_for_process` for co-owning layouts)."""
    n_axis = mesh.shape[axis]
    nproc = jax.process_count()
    if nproc == 1:
        return n_axis
    _, ng = data_group_for_process(mesh, axis)
    return n_axis // ng


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Multi-host bring-up: ``jax.distributed.initialize`` with env fallbacks.

    Arguments left as None are left to ``jax.distributed.initialize``, which
    discovers them only under a cluster manager it knows; on a bare GPU host
    pass ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly. Safe to call once per process before any
    device op.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def local_device_count() -> int:
    return jax.local_device_count()


def is_multihost() -> bool:
    return jax.process_count() > 1


def virtual_cpu_devices(n: int = 8) -> None:
    """Request ``n`` virtual CPU devices (test-only; must run before JAX init).

    Mirrors the conftest setup (SURVEY.md §4): multi-chip sharding is validated
    on a CPU-simulated mesh via ``--xla_force_host_platform_device_count``.
    """
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n}"
    )
