"""Ring-sharded negacyclic NTT over a device mesh, with hand-written exchanges.

Counterpart of `lol_tpu/ops/pallas/remote_ntt.py`.  For a ring too large
for one device, the coefficient axis is sharded over a mesh axis of size
D (`parallel/sharding.py`): an (n, B) array is D contiguous (tS, B) int32
shards, tS = n/D, shard d holding rows [d*tS, (d+1)*tS) on the axis's
d-th device.  Chunk e of a shard is its rows [e*C, (e+1)*C), C = tS/D:
one contiguous C*B span (in the JAX package's batch-major (..., n) it is
B strided pieces).  The radix-2 network factors into

  phase A: global stages 0..log2(D)-1, pairing rows tS apart: after the
           class exchange, a length-D network along the chunk axis of
           each shard's (D, C*B) view, twiddle base 1;
  phase B: the other stages, inside shard d's block, twiddle base D + d
           (`ops/ntt.dit_net_cm`; the JAX package's `_block_twiddles`).

and, per prime, as `_ring_sharded` there:

  forward  a2a[class] -> phase A -> a2a[block] -> phase B     (overlap=False)
                                 -> gather pass (+ block pass) (overlap=True)
  inverse  phase B' -> a2a[block]       (overlap=False)
           scatter pass (after its block pass) (overlap=True)
           -> phase A' (1/n folded into global stage 0) -> a2a[class]

Phase B runs `phase_b_passes`, `ntt_cm`'s schedule at base D + d, so the
gather and scatter passes have the geometry, threads and tile of the
unfused pass they fold the exchange into (a block pass follows only
above tS = 16384).

The chunk transpose `a2a_chunks` (out[d] chunk e = shard e's chunk d) is
an involution and serves both exchanges.  overlap=True folds the second
exchange into the phase-B pass: `ntt_fwd_gather` loads shard d's block
rows straight from every shard's phase-A output, `ntt_inv_scatter` stores
its rows straight into every shard's landing buffer.  It runs every shape
the two-call path runs; unlike the reference it never falls back to that
path, and a shape the kernels cannot run raises.

Kernels (`csrc/remote_ntt.cu`): `a2a_chunks` replaces `_a2a_kernel`,
`ntt_fwd_gather_pass` `_fused_a2a_phaseB_kernel`, `ntt_inv_scatter_pass`
`_fused_phaseBinv_a2a_kernel`; phases A and B, and the unfused phase B,
are `csrc/ntt.cu`'s pass kernels (counted under `ntt_kernel.LAUNCHES`).
Each wrapper launches its kernel for CUDA shards and raises on any build
or launch error; for CPU shards, and only then, it runs its plain torch
version (`*_ref`).  Shards may share a device (a mesh that repeats one
card: stream order is then enough) or sit on several cards of one host,
which must reach each other's memory (peer access, enabled here; events
order the phases).
"""

from __future__ import annotations

import ctypes

import torch

from ..ntt import NTTPlan, dit_net_cm, gs_net_cm
from . import build, ntt_kernel as tk

# One per kernel launch (a2a_chunks launches once per shard).  Reset by
# callers that check which kernels a path ran.
LAUNCHES = {"a2a": 0, "ntt_fwd_gather": 0, "ntt_inv_scatter": 0}
MAX_D = 8  # shards one kernel addresses (csrc/remote_ntt.cu)
A2A_THREADS = 256
_PEERS: set[tuple[int, int]] = set()  # (device, peer) pairs with peer access on

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
_U = ctypes.c_uint32


def _lib() -> ctypes.CDLL:
    lib = build.load()
    if lib.lol_a2a_chunks.argtypes is None:
        lib.lol_a2a_chunks.argtypes = [_P, _PP, _I, _I, ctypes.c_longlong, _I, _P]
        lib.lol_a2a_chunks.restype = _I
        lib.lol_ntt_ring_pass.argtypes = ([_I, _P, _P, _PP, _I, _I, _I, _P, _P]
                                          + [_I] * 12 + [_U, _P])
        lib.lol_ntt_ring_pass.restype = _I
        lib.lol_enable_peer_access.argtypes = [_I, _I]
        lib.lol_enable_peer_access.restype = _I
    return lib


def check_ring(n: int, D: int) -> tuple[int, int]:
    """(tS, C) = (n/D, n/D^2), with the reference's checks."""
    if D < 1 or n % D or D & (D - 1):
        raise ValueError("ring sharding needs a power-of-2 divisor of n")
    tS = n // D
    if tS % D:
        raise ValueError("need D^2 | n for the (D, C) chunking")
    return tS, tS // D


def phase_a_pass(D: int, C: int) -> tk.Pass:
    """Phase A (A') on a shard's (tS, B) rows: C length-D transforms whose
    elements lie C rows apart, twiddle base 1."""
    return tk.cross_pass(D, C, 1)


def phase_b_passes(tS: int, D: int, d: int) -> list[tk.Pass]:
    """Phase B of shard d in forward order (phase B' runs it reversed): the
    length-tS schedule of `ntt_cm` at twiddle base D + d (`cm_schedule`):
    one pass up to tS = 4096, one pass over a thread-block cluster at 8192
    and 16384, a cross and a block pass above."""
    return tk.cm_schedule(tS, base=D + d)


# ---------------------------------------------------------------------------
# plain versions (int64 torch; the kernels' checks and the CPU path)
# ---------------------------------------------------------------------------


def a2a_chunks_ref(shards: list[torch.Tensor]) -> list[torch.Tensor]:
    """Chunk transpose: out[d] chunk e = shards[e] chunk d (the reference's
    `_all_to_all` contract, out[e] on device d = x_e[d]); words moved raw."""
    D = len(shards)
    C = shards[0].shape[0] // D
    return [torch.cat([s[d * C:(d + 1) * C].to(shards[d].device) for s in shards])
            for d in range(D)]


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words read as u32 (the kernels' lazy words may pass 2^31), int64."""
    return x.long() & 0xFFFFFFFF


def phase_a_ref(x: torch.Tensor, plan: NTTPlan, D: int, inverse: bool) -> torch.Tensor:
    """Phase A (A') of one shard after the class exchange: a length-D
    network along the chunk axis of its (D, C*B) view; the inverse ends
    with the 1/n scale.  Any u32 words in, residues in [0, q) out."""
    q = plan.q
    v = _u32(x).view(D, -1) % q
    w = plan.tables(x.device)[2 if inverse else 0].long()
    y = gs_net_cm(v, w, q) * plan.n_inv % q if inverse else dit_net_cm(v, w, q)
    return y.view(x.shape).to(torch.int32)


def phase_b_ref(x: torch.Tensor, plan: NTTPlan, D: int, d: int, inverse: bool) -> torch.Tensor:
    """Phase B (B') of shard d's block: a length-tS network at twiddle base
    D + d (no 1/n scale).  Any u32 words in, residues in [0, q) out."""
    q = plan.q
    w = plan.tables(x.device)[2 if inverse else 0].long()
    net = gs_net_cm if inverse else dit_net_cm
    return net(_u32(x) % q, w, q, base=D + d).to(torch.int32)


def ntt_fwd_gather_ref(xs: list[torch.Tensor], plan: NTTPlan) -> list[torch.Tensor]:
    """The block exchange, then phase B of every shard."""
    D = len(xs)
    return [phase_b_ref(v, plan, D, d, False) for d, v in enumerate(a2a_chunks_ref(xs))]


def ntt_inv_scatter_ref(xs: list[torch.Tensor], plan: NTTPlan) -> list[torch.Tensor]:
    """Phase B' of every shard, then the block exchange."""
    D = len(xs)
    return a2a_chunks_ref([phase_b_ref(v, plan, D, d, True) for d, v in enumerate(xs)])


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_shards(xs: list[torch.Tensor], what: str,
                  plan: NTTPlan | None = None) -> tuple[int, int, int]:
    """(D, tS, B) of D int32 (tS, B) shards of one shape, all on the CPU or
    all on CUDA (there contiguous, and at most MAX_D); with a plan, also
    tS = n/D under the ring's checks."""
    D = len(xs)
    if D < 1 or any(x.dim() != 2 or x.dtype != torch.int32 or x.shape != xs[0].shape
                    for x in xs):
        raise ValueError(f"{what}: need D >= 1 int32 (tS, B) shards of one shape")
    tS, B = xs[0].shape
    if tS % D or B < 1:
        raise ValueError(f"{what}: {D} shards of {tS} rows do not split into {D} chunks")
    if plan is not None and check_ring(plan.n, D)[0] != tS:
        raise ValueError(f"{what}: {D} shards of {tS} rows do not hold n = {plan.n}")
    kinds = {x.device.type for x in xs}
    if kinds == {"cuda"}:
        if D > MAX_D:
            raise ValueError(f"{what}: the CUDA kernels address at most {MAX_D} shards, got {D}")
        if not all(x.is_contiguous() for x in xs):
            raise ValueError(f"{what}: the CUDA kernels need contiguous shards")
    elif kinds != {"cpu"}:
        raise ValueError(f"{what}: shards on {sorted(kinds)}; need all on the CPU or all on CUDA")
    return D, tS, B


def _on_cpu(xs: list[torch.Tensor]) -> bool:
    return xs[0].device.type == "cpu"


def _ptrs(xs: list[torch.Tensor]):
    return (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))


class _Streams:
    """The shards' devices and the order between the phases of a ring
    exchange.  When every shard sits on one device, its current stream
    orders everything and nothing is added.  Across devices, peer access
    is enabled once per pair, each exchange is fenced by events both ways
    (every device's stream waits for every other's work so far), and a
    buffer another device's stream touches is recorded on that stream."""

    def __init__(self, xs: list[torch.Tensor]):
        self.devices = [x.device for x in xs]
        self.distinct = list(dict.fromkeys(self.devices))
        if len(self.distinct) > 1:
            _enable_peer_access(self.distinct)

    def stream(self, d: int) -> torch.cuda.Stream:
        return torch.cuda.current_stream(self.devices[d])

    def barrier(self) -> None:
        if len(self.distinct) < 2:
            return
        events = {dev: torch.cuda.current_stream(dev).record_event() for dev in self.distinct}
        for dev in self.distinct:
            s = torch.cuda.current_stream(dev)
            for other, ev in events.items():
                if other != dev:
                    s.wait_event(ev)

    def touched(self, bufs: list[torch.Tensor], d: int) -> None:
        """Shard d's stream reads or writes bufs."""
        if len(self.distinct) < 2:
            return
        s = self.stream(d)
        for b in bufs:
            if b.device != self.devices[d]:
                b.record_stream(s)


def _enable_peer_access(devices: list[torch.device]) -> None:
    lib = _lib()
    for a in devices:
        for b in devices:
            if a == b or (a.index, b.index) in _PEERS:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f"{a} cannot address {b}'s memory (no peer access); "
                                   "the ring's kernels need it")
            build.check(lib.lol_enable_peer_access(a.index, b.index),
                        f"peer access {a} -> {b}")
            _PEERS.add((a.index, b.index))


def a2a_chunks(shards: list[torch.Tensor]) -> list[torch.Tensor]:
    """The chunk all-to-all of D (tS, B) int32 shards (tS divisible by D):
    out[d] chunk e = shards[e] chunk d.  One kernel launch per shard, each
    pushing its D chunks to their addressees."""
    D, tS, B = _check_shards(shards, "a2a_chunks")
    if _on_cpu(shards):
        return a2a_chunks_ref(shards)
    lib = _lib()
    streams = _Streams(shards)
    outs = [torch.empty_like(x) for x in shards]
    ptrs = _ptrs(outs)
    streams.barrier()
    for d, x in enumerate(shards):
        with torch.cuda.device(x.device):
            err = lib.lol_a2a_chunks(x.data_ptr(), ptrs, D, d, tS // D * B, A2A_THREADS,
                                     streams.stream(d).cuda_stream)
        build.check(err, f"a2a_chunks shard {d} (D={D}, tS={tS}, B={B})")
        LAUNCHES["a2a"] += 1
        streams.touched(outs, d)
    streams.barrier()
    return outs


def _ring_pass(scatter: bool, x, y, peers: list[torch.Tensor], d: int, plan: NTTPlan,
               p: tk.Pass, last: bool, stream) -> None:
    """Launch shard d's gather (scatter=False) or scatter pass p, with the
    threads and tile of the unfused pass of the same geometry."""
    lib = _lib()
    D = len(peers)
    tS, B = peers[0].shape
    dev = peers[d].device
    w, wsh, iw, iwsh = plan.tables(dev)
    tw, twsh = (iw, iwsh) if scatter else (w, wsh)
    with torch.cuda.device(dev):
        err = lib.lol_ntt_ring_pass(
            int(scatter), None if x is None else x.data_ptr(),
            None if y is None else y.data_ptr(), _ptrs(peers), D, tS // D, d,
            tw.data_ptr(), twsh.data_ptr(), B, p.L, p.nseq, p.elem_stride,
            p.seq_stride, p.base0, p.base_step, p.G, p.TB, tk.kernel_threads(p),
            p.cluster.bit_length() - 1, int(last), plan.q, stream.cuda_stream,
        )
    name = "ntt_inv_scatter" if scatter else "ntt_fwd_gather"
    build.check(err, f"{name} shard {d} (D={D}, tS={tS}, B={B}, L={p.L})")
    LAUNCHES[name] += 1


def ntt_fwd_gather(xs: list[torch.Tensor], plan: NTTPlan) -> list[torch.Tensor]:
    """Phase B of every shard with the block exchange folded into its
    first pass: shard d's kernel loads block row e*C + c from row d*C + c
    of shard e's phase-A output xs[e] (lazy words below 4q are fine).
    Returns the D phase-B outputs, residues in [0, q)."""
    D, tS, B = _check_shards(xs, "ntt_fwd_gather", plan)
    if _on_cpu(xs):
        return ntt_fwd_gather_ref(xs, plan)
    streams = _Streams(xs)
    streams.barrier()
    outs = []
    for d, x in enumerate(xs):
        passes = phase_b_passes(tS, D, d)
        y = torch.empty_like(x)
        _ring_pass(False, None, y, xs, d, plan, passes[0], len(passes) == 1, streams.stream(d))
        streams.touched(xs, d)
        if len(passes) > 1:
            tk.run_passes(y, plan, passes[1:], inverse=False, out=y)
        outs.append(y)
    return outs


def ntt_inv_scatter(xs: list[torch.Tensor], plan: NTTPlan) -> list[torch.Tensor]:
    """Phase B' of every shard with the block exchange folded into its last
    pass: shard d's kernel stores block row e*C + c to row d*C + c of shard
    e's landing buffer.  Returns the D landing buffers; their words are the
    lazy [0, 2q) form that phase A' takes (equal mod q to the plain
    version's)."""
    D, tS, B = _check_shards(xs, "ntt_inv_scatter", plan)
    if _on_cpu(xs):
        return ntt_inv_scatter_ref(xs, plan)
    streams = _Streams(xs)
    lands = [torch.empty_like(x) for x in xs]
    streams.barrier()
    for d, x in enumerate(xs):
        passes = phase_b_passes(tS, D, d)[::-1]
        src = x
        if len(passes) > 1:
            src = tk.run_passes(x, plan, passes[:-1], inverse=True, last=False)
        _ring_pass(True, src, None, lands, d, plan, passes[-1], False, streams.stream(d))
        streams.touched(lands, d)
    streams.barrier()
    return lands


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------


def phase_a(x: torch.Tensor, plan: NTTPlan, D: int, inverse: bool) -> torch.Tensor:
    """Phase A (A') of one shard after the class exchange: on CUDA the pass
    kernel, in place on x (an exchange's output); A' holds global stage 0,
    so it carries n^-1 and folds to [0, q), while A's output stays lazy
    (below 4q).  On the CPU `phase_a_ref`."""
    if _on_cpu([x]):
        return phase_a_ref(x, plan, D, inverse)
    p = phase_a_pass(D, x.shape[0] // D)
    return tk.run_passes(x, plan, [p], inverse, last=inverse, out=x)


def phase_b(x: torch.Tensor, plan: NTTPlan, D: int, d: int, inverse: bool) -> torch.Tensor:
    """Unfused phase B of shard d on CUDA: in place on x (an exchange's
    output), folding to [0, q); or B', out of place on the caller's shard,
    lazy out (below 2q).  On the CPU `phase_b_ref`."""
    if _on_cpu([x]):
        return phase_b_ref(x, plan, D, d, inverse)
    passes = phase_b_passes(x.shape[0], D, d)
    if inverse:
        return tk.run_passes(x, plan, passes[::-1], True, last=False)
    return tk.run_passes(x, plan, passes, False, out=x)


def _ring(mesh, shards, plan, axis, inverse, overlap):
    devices = mesh.axis_devices(axis)
    D = len(devices)
    check_ring(plan.n, D)
    if len(shards) != D:
        raise ValueError(f"ring transform: {len(shards)} shards for a {axis} axis of {D}")
    _check_shards(shards, "ring transform", plan)
    for d, (x, dev) in enumerate(zip(shards, devices)):
        if x.device != dev:
            raise ValueError(f"ring transform: shard {d} is on {x.device}, its mesh device is {dev}")
    if D == 1:  # one shard holds the ring
        return [tk.ntt_cm(shards[0], plan, inverse=inverse)]
    if not inverse:
        x = [phase_a(v, plan, D, False) for v in a2a_chunks(shards)]
        if overlap:
            return ntt_fwd_gather(x, plan)
        return [phase_b(v, plan, D, d, False) for d, v in enumerate(a2a_chunks(x))]
    if overlap:
        x = ntt_inv_scatter(shards, plan)
    else:
        x = a2a_chunks([phase_b(v, plan, D, d, True) for d, v in enumerate(shards)])
    return a2a_chunks([phase_a(v, plan, D, True) for v in x])


def ntt_ring_sharded_cm(mesh, shards: list[torch.Tensor], plan: NTTPlan,
                        axis: str = "ring", overlap: bool = False) -> list[torch.Tensor]:
    """Forward negacyclic NTT of an (n, B) array held as the D ring shards
    of mesh axis `axis` (shard d, (n/D, B) int32 residues in [0, q), on
    the axis's d-th device); returns the output's D shards the same way
    (bit-reversed-exponent order, as `ntt_cm`).  D a power of 2, D^2 | n.
    overlap=True folds the block exchange into phase B's first pass
    (`ntt_fwd_gather`); both routes give the same bits."""
    return _ring(mesh, shards, plan, axis, False, overlap)


def intt_ring_sharded_cm(mesh, shards: list[torch.Tensor], plan: NTTPlan,
                         axis: str = "ring", overlap: bool = False) -> list[torch.Tensor]:
    """Inverse of `ntt_ring_sharded_cm` (1/n included): the mirror
    dataflow; overlap=True folds the block exchange into phase B''s last
    pass (`ntt_inv_scatter`)."""
    return _ring(mesh, shards, plan, axis, True, overlap)
