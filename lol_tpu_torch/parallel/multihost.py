"""Multi-process meshes: bring-up and a mesh that spans every process.

Counterpart of `lol_tpu/parallel/multihost.py`.  The port's mesh code is
shape agnostic, "same code, bigger mesh" (SURVEY.md §3.9 / §6); this
module adds the process group and a mesh over all of its processes:

    from lol_tpu_torch.parallel import multihost
    multihost.initialize()                       # env:// (MASTER_ADDR, RANK, ...)
    mesh = multihost.global_mesh({"data": -1, "rns": 3})
    step = bb.build_step(hint, mesh=mesh)         # runs on this process's entries
    out = step(*(sharding.shard_batch_rns(mesh, c) for c in cts))   # its own columns

The layout rule is the reference's: the first axis, 'data', crosses
processes and every other axis ('rns') stays inside one, so the
builders' cross-channel copies (`rns_gather`, `rns_relayout`) stay
copies inside a process, and a process computes its own columns with no
collective at all.  A shape whose other axes would cross processes is
refused.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import sharding


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Bring up the torch.distributed process group (idempotent).

    coordinator_address: 'host:port' (or a full init URL), with the world
    size and this process's rank; without one the `env://` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) name them.  backend: by
    default "nccl" where CUDA is available and "gloo" elsewhere; a caller
    that wants gloo beside its cards (NCCL refuses two ranks on one card)
    says so."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if coordinator_address is None:
        init = "env://"
    else:
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, **kw)


def rank_grid(shape: dict[str, int], per_process: int, world: int) -> np.ndarray:
    """The rank of each entry of a mesh over `world` processes of
    `per_process` entries each, in row-major order, process by process,
    with `shape`'s -1 axis (at most one) resolved; refuses a count that
    does not fit and a layout whose axes other than a first 'data' axis
    cross processes."""
    names, dims = list(shape), list(shape.values())
    total = per_process * world
    if dims.count(-1) > 1:
        raise ValueError("global_mesh: at most one -1 axis")
    known = int(np.prod([d for d in dims if d != -1]))
    if -1 in dims:
        if total % known:
            raise ValueError(f"global_mesh: {total} devices not divisible by {known}")
        dims[dims.index(-1)] = total // known
    if int(np.prod(dims)) != total:
        raise ValueError(f"global_mesh: shape {dims} != device count {total}")
    ranks = np.repeat(np.arange(world), per_process).reshape(dims)
    for ax, name in enumerate(names):
        if ax == 0 and name == "data":
            continue
        if (np.moveaxis(ranks, ax, -1) != np.moveaxis(ranks, ax, -1)[..., :1]).any():
            raise ValueError(
                f"global_mesh: axis {name!r} (size {dims[ax]}) would cross processes of "
                f"{per_process} devices each; only a first 'data' axis may cross them, "
                "and 'rns' stays inside one process")
    return ranks


def global_mesh(shape: dict[str, int], local_devices=None) -> sharding.Mesh:
    """A mesh over the devices of every process of the group.

    local_devices: this process's entries, in order (a device may repeat,
    as `make_mesh`'s `devices=`); by default the visible cards.  Every
    process holds as many; the entries of process r come r-th in
    row-major order, and the others' entries name their devices as this
    process's list does (a process only touches its own, `Mesh.local`).
    shape maps axis name -> size, at most one -1 absorbing the rest; put
    the axis that crosses processes, 'data', first."""
    if local_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA device is available; name this "
                               "process's devices (e.g. local_devices=['cpu'] * k)")
        local_devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [sharding._canonical(d) for d in local_devices]
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = rank_grid(shape, len(local), world)
    grid = np.empty(ranks.size, dtype=object)
    grid[:] = local * world
    return sharding.Mesh(grid.reshape(ranks.shape), tuple(shape), ranks)
