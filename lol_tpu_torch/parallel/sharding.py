"""Device meshes and sharded ring / SHE pipelines.

Counterpart of `lol_tpu/parallel/sharding.py`.  The JAX package drives a
mesh from one process through `shard_map`; the port's mesh is the same in
one process: named axes over an array of `torch.device`s, on which the
caller places the shards.  A device may repeat.  `make_mesh({"ring": 4})`
on a one-card machine is four entries of `cuda:0`: every exchange is then
a copy inside that card's memory, through the same kernels, chunk
addressing and twiddles as across cards.  A mesh may also span processes
(`parallel.multihost.global_mesh`): its first axis, 'data', crosses them
and every other axis stays inside one; each process then runs the same
code on its own entries (`Mesh.local`), the rns x data functions below
take that part, and `shard_batch_rns` places only the process's own
columns.

Layouts (coefficient-major, as the port's `ntt_cm`):

- ring: an (n, B) array over the D devices of an axis is D contiguous
  (n/D, B) int32 shards, shard d holding rows [d*n/D, (d+1)*n/D) on the
  axis's d-th device (`ring_shard`, `ring_unshard`);
- rns x data: an (nrns, n, B) stack is an (R, Dd) grid of blocks, the
  channels split over 'rns' and the batch over 'data' (`shard_batch_rns`).
  Where R does not divide the channel count (the rescale leaves nrns - 1
  channels; the extended chain has nrns + k) the stack is data-only
  blocks, (1, Dd), on rns row 0's devices: `rns_rows` states the rule,
  and the mesh-aware builders of `she_batched` take and give this layout.
  Their cross-channel reads are explicit copies: `rns_gather` replicates
  each data column's full channel stack onto every device of its column
  (the all-gather the JAX package asks of XLA), `rns_scatter` is its
  inverse, and `rns_relayout` moves a stack whose rows hold uneven
  channel runs (after a rescale) into the rule's layout.  On a one-card
  mesh these are copies inside that card's memory.

`ntt_ring_sharded` is the plain torch version of the whole ring-sharded
forward transform (phase A along the block axis, then each block's
network), which the tests and the kernels' checks use; the kernels' route
is `ops/cuda/remote_ntt.ntt_ring_sharded_cm`.  `batched_ntt_sharded` runs
`ntt_cm` per block on its device; `batched_hadamard_sharded` is plain
torch, as XLA computes it in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import zq
from ..ops.cuda import ntt_kernel as tk
from ..ops.ntt import NTTPlan, dit_net_cm


@dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an object array of `torch.device`s (one array axis
    per name; entries may repeat).  `ranks`, where the mesh spans several
    processes (`parallel.multihost.global_mesh`), is the rank of the
    process that holds each entry; those entries are a contiguous run of
    the first axis (the layout rule), and `local()` is the sub-mesh of
    one process's entries.  None: every entry is this process's."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    ranks: np.ndarray | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_rows(self, rank: int | None = None) -> slice:
        """The run of the first axis that process `rank` (this process by
        default) holds."""
        if self.ranks is None:
            return slice(0, self.devices.shape[0])
        if rank is None:
            rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
        rows = np.flatnonzero((self.ranks == rank).reshape(self.ranks.shape[0], -1).any(1))
        if rows.size == 0:
            raise ValueError(f"Mesh: process {rank} holds no entry of {self.shape}")
        return slice(int(rows[0]), int(rows[-1]) + 1)

    def local(self, rank: int | None = None) -> "Mesh":
        """The entries of process `rank` (this process's by default), as a
        one-process mesh with the same axes."""
        if self.ranks is None:
            return self
        return Mesh(self.devices[self.local_rows(rank)].copy(), self.axis_names)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        ax = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, ax, 0).reshape(self.devices.shape[ax], -1)[:, 0])


def _canonical(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: dict[str, int], devices=None) -> Mesh:
    """A mesh with named axes, e.g. {"ring": 4} or {"rns": 2, "data": 4}.

    devices: the devices in row-major mesh order (a device may repeat);
    by default the visible CUDA cards, round-robin.  With no card and no
    devices it raises: the CPU serves only a caller that names it."""
    names, dims = tuple(shape), tuple(shape.values())
    count = int(np.prod(dims))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; name the devices "
                               "(e.g. devices=['cpu'] * n) to build a mesh without one")
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(count)]
    devices = [_canonical(d) for d in devices]
    if len(devices) < count:
        raise ValueError(f"mesh needs {count} devices, have {len(devices)}")
    grid = np.empty(count, dtype=object)
    grid[:] = devices[:count]
    return Mesh(grid.reshape(dims), names)


# ---------------------------------------------------------------------------
# ring-axis sharding (large n)
# ---------------------------------------------------------------------------


def ring_shard(x: torch.Tensor, mesh: Mesh, axis: str = "ring") -> list[torch.Tensor]:
    """An (n, B) tensor as the D ring shards of mesh axis `axis` (copies)."""
    devices = mesh.axis_devices(axis)
    D = len(devices)
    if x.dim() != 2 or x.shape[0] % D:
        raise ValueError(f"ring_shard: need (n, B) with D={D} | n, got {tuple(x.shape)}")
    tS = x.shape[0] // D
    return [x[d * tS:(d + 1) * tS].to(dev, copy=True, memory_format=torch.contiguous_format)
            for d, dev in enumerate(devices)]


def ring_unshard(shards: list[torch.Tensor]) -> torch.Tensor:
    """The (n, B) tensor the ring shards hold, on shard 0's device."""
    return torch.cat([s.to(shards[0].device) for s in shards])


def ntt_ring_sharded(mesh: Mesh, shards: list[torch.Tensor], plan: NTTPlan,
                     axis: str = "ring") -> list[torch.Tensor]:
    """Plain torch forward negacyclic NTT of the (n, B) array held as the
    ring shards of `axis`; returns the output's shards the same way.

    The structural split of the JAX package's `ntt_ring_sharded`: in the
    (D, n/D) view the first log2 D stages pair rows n/D apart (a length-D
    network along the block axis); the rest stay inside each contiguous
    block, block d at twiddle base D + d."""
    devices = mesh.axis_devices(axis)
    D = len(devices)
    n, q = plan.n, plan.q
    if n % D or D & (D - 1):
        raise ValueError("ring sharding needs power-of-2 divisor of n")
    tS = n // D
    x = ring_unshard(shards).long() % q
    if x.shape[0] != n:
        raise ValueError(f"ntt_ring_sharded: the shards hold {x.shape[0]} rows, plan has n={n}")
    B = x.shape[1]
    w = plan.tables(x.device)[0].long()
    x = dit_net_cm(x.view(D, tS * B), w, q).view(D, tS, B)
    return [dit_net_cm(x[d], w, q, base=D + d).to(torch.int32).to(dev)
            for d, dev in enumerate(devices)]


# ---------------------------------------------------------------------------
# rns x data sharding (the steady-state workhorse)
# ---------------------------------------------------------------------------


def rns_data_grid(mesh: Mesh) -> np.ndarray:
    """The (rns, data) grid of this process's devices, at index 0 of any
    other axis."""
    r, d = mesh.axis_names.index("rns"), mesh.axis_names.index("data")
    grid = np.moveaxis(mesh.local().devices, (r, d), (0, 1))
    return grid.reshape(grid.shape[0], grid.shape[1], -1)[:, :, 0]


def data_mesh(mesh: Mesh) -> Mesh:
    """The data-only view of an rns x data mesh: rns row 0's devices as a
    {"rns": 1, "data": Dd} mesh (every stack on it is data-only blocks)."""
    grid = rns_data_grid(mesh)
    return Mesh(grid[:1].copy(), ("rns", "data"))


def rns_rows(mesh: Mesh, nrns: int) -> int:
    """The block rows of an nrns-channel stack on the mesh: R = the 'rns'
    axis' size where R divides nrns, else 1 (data-only)."""
    R = rns_data_grid(mesh).shape[0]
    return R if nrns % R == 0 else 1


def local_columns(mesh: Mesh, B: int) -> slice:
    """The columns of a B-column batch that this process holds on `mesh`:
    all B on a one-process mesh; on one that spans processes, the run of
    the global 'data' axis its entries cover (B split evenly over it)."""
    if mesh.ranks is None:
        return slice(0, B)
    if mesh.axis_names[0] != "data":
        raise ValueError("local_columns: 'data' must be the first axis of a mesh that spans "
                         "processes")
    Dd = mesh.devices.shape[0]
    if B % Dd:
        raise ValueError(f"local_columns: {B} columns do not split over data={Dd}")
    rows = mesh.local_rows()
    return slice(rows.start * (B // Dd), rows.stop * (B // Dd))


def shard_batch_rns(mesh: Mesh, x: torch.Tensor, batch_axis: int = 2) -> np.ndarray:
    """Place an (nrns, n, B) stack as an object array of blocks: (R, Dd)
    with the channels split over 'rns' where R divides nrns, else (1, Dd)
    data-only (`rns_rows`); axis `batch_axis` split over 'data'; block
    (i, j) on the mesh's device (i, j).  On a mesh that spans processes x
    is the whole batch, every process's columns, and each process places
    only its own (`local_columns`) on its own entries."""
    if mesh.ranks is not None:
        idx = [slice(None)] * x.dim()
        idx[batch_axis] = local_columns(mesh, x.shape[batch_axis])
        x = x[tuple(idx)]
    grid = rns_data_grid(mesh)
    rows, Dd = rns_rows(mesh, x.shape[0]), grid.shape[1]
    if x.shape[batch_axis] % Dd:
        raise ValueError(f"shard_batch_rns: {tuple(x.shape)} does not split over data={Dd}")
    blocks = np.empty((rows, Dd), dtype=object)
    for i, chans in enumerate(x.chunk(rows, 0)):
        for j, blk in enumerate(chans.chunk(Dd, batch_axis)):
            blocks[i, j] = blk.to(grid[i, j], copy=True, memory_format=torch.contiguous_format)
    return blocks


def unshard_batch_rns(blocks: np.ndarray, batch_axis: int = 2) -> torch.Tensor:
    """The stack the blocks of `shard_batch_rns` hold, on block (0, 0)'s
    device: on a mesh that spans processes, this process's columns."""
    dev = blocks[0, 0].device
    return torch.cat([torch.cat([b.to(dev) for b in row], batch_axis) for row in blocks])


def _assemble(pieces: list[torch.Tensor], device) -> torch.Tensor:
    """The pieces stacked along axis 0 into a new tensor on `device`, each
    copied once (across devices, straight from its own)."""
    out = torch.empty((sum(t.shape[0] for t in pieces), *pieces[0].shape[1:]),
                      dtype=pieces[0].dtype, device=device)
    lo = 0
    for t in pieces:
        out[lo:lo + t.shape[0]].copy_(t)
        lo += t.shape[0]
    return out


def rns_gather(mesh: Mesh, blocks: np.ndarray) -> np.ndarray:
    """(R, Dd) object array whose entry (i, j) is data column j's full
    channel stack (its blocks' rows concatenated, any number of rows) on
    the mesh's device (i, j): a copy on each device."""
    grid = rns_data_grid(mesh)
    out = np.empty(grid.shape, dtype=object)
    for j in range(grid.shape[1]):
        col = [blocks[r, j] for r in range(blocks.shape[0]) if blocks[r, j].shape[0]]
        for i in range(grid.shape[0]):
            out[i, j] = _assemble(col, grid[i, j])
    return out


def rns_scatter(mesh: Mesh, full: np.ndarray) -> np.ndarray:
    """The inverse of `rns_gather`: from each data column's replicated
    full stack, every device keeps its own rows of `shard_batch_rns`'s
    layout (a copy of its slice; rns row 0's copy for data-only blocks)."""
    rows = rns_rows(mesh, full[0, 0].shape[0])
    per = full[0, 0].shape[0] // rows
    out = np.empty((rows, full.shape[1]), dtype=object)
    for (i, j), _ in np.ndenumerate(out):
        out[i, j] = full[i, j][i * per:(i + 1) * per].clone()
    return out


def rns_relayout(mesh: Mesh, parts: np.ndarray) -> np.ndarray:
    """Blocks whose rows hold consecutive channel runs of any lengths
    (part (r, j) on device (r, j); a rescale leaves the last row one
    channel short) in `shard_batch_rns`'s layout for their channel count:
    each block gathers its channels from the parts that hold them.
    Blocks already in that layout come back as they are."""
    grid = rns_data_grid(mesh)
    counts = [parts[r, 0].shape[0] for r in range(parts.shape[0])]
    rows = rns_rows(mesh, sum(counts))
    per = sum(counts) // rows
    if counts == [per] * rows:
        return parts
    out = np.empty((rows, grid.shape[1]), dtype=object)
    for (i, j), _ in np.ndenumerate(out):
        pieces, lo = [], 0
        for r, c in enumerate(counts):
            a, b = max(lo, i * per), min(lo + c, (i + 1) * per)
            if a < b:
                pieces.append(parts[r, j][a - lo:b - lo])
            lo += c
        out[i, j] = _assemble(pieces, grid[i, j])
    return out


def batched_ntt_sharded(mesh: Mesh, blocks: np.ndarray, plans: list[NTTPlan],
                        inverse: bool = False) -> np.ndarray:
    """Forward (inverse) NTT of every channel of the (nrns, n, B) stack held
    as `shard_batch_rns` blocks: `ntt_cm` per channel on its block's
    device, no exchange.  Returns blocks of the same layout."""
    R = blocks.shape[0]
    per = len(plans) // R
    out = np.empty(blocks.shape, dtype=object)
    for (i, j), blk in np.ndenumerate(blocks):
        out[i, j] = torch.stack([tk.ntt_cm(blk[k], plans[i * per + k], inverse=inverse)
                                 for k in range(blk.shape[0])])
    return out


def batched_hadamard_sharded(mesh: Mesh, a: np.ndarray, b: np.ndarray,
                             qs: tuple[int, ...]) -> np.ndarray:
    """Channel-wise products a*b mod q of two `shard_batch_rns` stacks of
    residues, per block on its device (plain int64 torch)."""
    R = a.shape[0]
    per = len(qs) // R
    out = np.empty(a.shape, dtype=object)
    for (i, j), x in np.ndenumerate(a):
        y = b[i, j]
        out[i, j] = torch.stack([zq.mul_mod(x[k], y[k], qs[i * per + k]).to(torch.int32)
                                 for k in range(x.shape[0])])
    return out
