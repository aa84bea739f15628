"""Entry points of the port: the counterpart of the JAX tree's
`__graft_entry__.py`, kept as the port's own copy.

- `entry(device="cuda")`: `(step, args)`, the fused batched BGV step
  (ct-mult -> RNS-gadget key switch -> exact rescale) of
  `she_batched.BatchedBGV`, eager, with its inputs on the device.
- `dryrun_multichip(n_devices, device="cuda")`: an ("rns" x "data") mesh of
  n_devices entries (the visible cards round-robin, so one card repeated
  where there is one; `"cpu"` entries only when device="cpu"), ciphertext
  stacks as `shard_batch_rns` blocks, and every mesh builder of the JAX
  dry run (the step LSD and MSD, the ext step, mod switch, the linear key
  switch and its ext form, hoisted Galois, the general-m step at m = 36),
  each unsharded == the unsharded builder; then the ring-sharded NTT over
  a "ring" axis of all n_devices entries, the plain transform and the
  kernel route (`ops/cuda/remote_ntt.ntt_ring_sharded_cm`, both `overlap`
  settings), each == `ops.ntt.np_ntt_forward`.

Run on the CPU: `python -m lol_tpu_torch.entry --device cpu` (both); on the
card with no flag.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import gadget as gd, numtheory as nt, prng, she
from .ops import ntt as ntt_mod
from .ops.cuda import remote_ntt
from .parallel import sharding as sh
from .she_batched import BatchedBGV


def _tiny_setup(m=32, nrns=3, p=257, batch=4, seed=0, device="cuda"):
    """(bb, sk, hint, (c0, c1, d0, d1)): the reference's tiny pipeline,
    the same keys, draws and plaintexts, on device."""
    qs = tuple(nt.ntt_primes(m, 30, nrns))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    key = prng.PRNGKey(seed)
    ks, kh, k1, k2 = prng.split(key, 4)
    sk = she.gen_sk(params, ks, device=device)
    hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), kh, device=device)
    bb = BatchedBGV(params, use_pallas=False, device=device)
    rng = np.random.default_rng(seed)
    cts_a = [she.encrypt(sk, she.pt_random(params, rng, device="cpu"), k, device=device)
             for k in prng.split(k1, batch)]
    cts_b = [she.encrypt(sk, she.pt_random(params, rng, device="cpu"), k, device=device)
             for k in prng.split(k2, batch)]
    c0, c1 = bb.pack(cts_a)
    d0, d1 = bb.pack(cts_b)
    return bb, sk, hint, (c0, c1, d0, d1)


def entry(device="cuda"):
    """(fn, example_args): the fused BGV mul+keyswitch+rescale step."""
    bb, _sk, hint, args = _tiny_setup(device=device)
    step = bb.build_step(hint)
    return step, args


def _assert_same(got, want) -> None:
    for a, b in zip(got, want):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError("mesh output != unsharded output")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The reference's dry run on the port's mesh; raises on any mismatch."""
    devices = None if torch.device(device).type == "cuda" else [device] * n_devices
    # rns axis x data(batch) axis; rns dim must divide nrns below
    drns = 3 if n_devices % 3 == 0 else (2 if n_devices % 2 == 0 else 1)
    ddp = n_devices // drns
    mesh = sh.make_mesh({"rns": drns, "data": ddp}, devices)
    home = mesh.devices[0, 0]

    nrns = max(drns, 2)
    batch = 2 * ddp
    bb, sk, hint, args = _tiny_setup(nrns=nrns, batch=batch, device=home)
    blocks = [sh.shard_batch_rns(mesh, x) for x in args]

    def check(mesh_fn, plain_fn, n_in):
        """unshard(mesh_fn(blocks)) == plain_fn(unsharded inputs)."""
        got, want = mesh_fn(*blocks[:n_in]), plain_fn(*args[:n_in])
        if isinstance(got, dict):
            for k in want:
                _assert_same([sh.unshard_batch_rns(b) for b in got[k]], want[k])
        else:
            _assert_same([sh.unshard_batch_rns(b) for b in got], want)

    # the step through the mesh (the digit broadcast an explicit gather over
    # 'rns'), LSD and MSD, against the unsharded pipeline
    params = bb.params
    bb_np = type(bb)(params, use_pallas=False, device=home)
    for encoding in ("lsd", "msd"):
        check(bb.build_step(hint, encoding=encoding, mesh=mesh),
              bb_np.build_step(hint, encoding=encoding), 4)

    # the serving builders under the mesh: the ext step, the standalone mod
    # switch, the linear key switch and its ext form, hoisted rotations
    all_primes = tuple(nt.ntt_primes(params.m, 30, nrns + 2))
    hx = bb.gen_ks_quad_hint_ext(sk, all_primes[nrns:], prng.PRNGKey(7))
    check(bb.build_step_ext(hx, mesh=mesh), bb_np.build_step_ext(hx), 4)
    check(bb.build_mod_switch(mesh=mesh), bb_np.build_mod_switch(), 2)
    sk_new = she.gen_sk(params, prng.PRNGKey(8), device=home)
    lh = bb.gen_ks_linear_hint(sk_new, sk, prng.PRNGKey(9))
    check(bb.build_key_switch_linear(lh, mesh=mesh), bb_np.build_key_switch_linear(lh), 2)
    gh = {k: bb.gen_galois_hint(k, sk, prng.fold_in(prng.PRNGKey(10), k)) for k in (3, 5)}
    check(bb.build_galois_many(gh, mesh=mesh), bb_np.build_galois_many(gh), 2)
    lhx = bb.gen_ks_linear_hint_ext(sk_new, sk, all_primes[nrns:], prng.PRNGKey(11))
    check(bb.build_key_switch_linear_ext(lhx, mesh=mesh),
          bb_np.build_key_switch_linear_ext(lhx), 2)

    # general-m leg: composite m = 36 through the sharded step
    bbg, _skg, hintg, argsg = _tiny_setup(m=36, nrns=nrns, batch=batch, seed=1, device=home)
    got = bbg.build_step(hintg, mesh=mesh)(*(sh.shard_batch_rns(mesh, x) for x in argsg))
    want = type(bbg)(bbg.params, use_pallas=False, device=home).build_step(hintg)(*argsg)
    _assert_same([sh.unshard_batch_rns(b) for b in got], want)

    # ring-axis leg: the coefficient axis sharded over all the entries, the
    # plain transform and the kernel route at both overlap settings
    n_ring = max(64, 8 * n_devices)
    q = nt.ntt_primes(2 * n_ring, 30, 1)[0]
    plan = ntt_mod.ntt_plan(n_ring, q)
    ring_mesh = sh.make_mesh({"ring": n_devices}, devices)
    rng = np.random.default_rng(1)
    xr = rng.integers(0, q, (1, n_ring), dtype=np.uint64).astype(np.uint32)
    want = ntt_mod.np_ntt_forward(xr, plan).astype(np.int64)
    x_cm = torch.from_numpy(xr.T.astype(np.int32).copy())  # (n, B = 1) coefficient-major
    shards = sh.ring_shard(x_cm, ring_mesh)
    outs = {"plain": sh.ntt_ring_sharded(ring_mesh, shards, plan)}
    for overlap in (False, True):
        outs[f"kernels, overlap={overlap}"] = remote_ntt.ntt_ring_sharded_cm(
            ring_mesh, shards, plan, overlap=overlap)
    for route, out in outs.items():
        got = sh.ring_unshard(out).cpu().numpy().T.astype(np.int64) & 0xFFFFFFFF
        if not np.array_equal(got, want):
            raise AssertionError(f"ring-sharded NTT ({route}) != np_ntt_forward")

    print(
        f"dryrun_multichip ok: mesh {mesh.shape}, "
        f"BGV step over (nrns={nrns}, n={params.ctx.n}, B={batch}) sharded "
        f"(rns, -, data) in LSD + MSD encodings; ext-modulus keyswitch "
        f"step, standalone mod-switch and linear keyswitch; hoisted "
        f"rotation batch (galois_many) and ext-modulus linear keyswitch; "
        f"general-m (m=36) sharded step; ring-sharded NTT n={n_ring} over "
        f"{n_devices}-device 'ring' axis (plain and kernel routes)"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="The port's entry points: entry()'s step and "
                                             "dryrun_multichip(n).")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--devices", type=int, default=4, help="mesh entries of the dry run")
    args = ap.parse_args(argv)
    step, inputs = entry(args.device)
    e0, e1 = step(*inputs)
    print(f"entry ok: step -> e0 {tuple(e0.shape)} {e0.dtype}, e1 {tuple(e1.shape)} on {e0.device}")
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
