"""generate / suppress / verify phases and the CLI (reference:
`rlwe-challenges/.../{Generate,Suppress,Verify,Main}.hs`); counterpart of
`lol_tpu/challenges/driver.py`, with its directory layout and file names.

`generate` draws every secret, error and uniform element from one CPU
`torch.Generator(seed)`, in a fixed order per instance, so a seed names
the same directory whichever device runs the ring work (`a s + e`, the
CRT transforms, RLWR's rounding); `verify` recomputes `a s` and the
error's norm on its device.  Either package's `verify` reads either
package's directory: it reads files and draws nothing.

    python -m lol_tpu_torch.challenges.driver generate DIR --params FILE [--seed S]
    python -m lol_tpu_torch.challenges.driver suppress DIR [--beacon-records RECS]
    python -m lol_tpu_torch.challenges.driver verify DIR [--beacon-records RECS]

(`--device cpu` runs the plain versions; the card by default.)
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from .. import rlwe, sampling
from ..cyc import Cyc, Rep
from ..io import cyc_from_proto, cyc_to_proto, ints_from_proto, ints_to_proto
from ..proto import wire as pb
from ..ring import lift_centered, ring_context
from .beacon import Beacon, LocalBeacon


@dataclass(frozen=True)
class ChallengeParams:
    """One line of the reference's params file."""

    challenge_id: int
    m: int
    q: int
    svar: float
    num_instances: int
    kind: str  # "disc" | "cont" | "rlwr"
    qprime: int = 0
    beacon_epoch: int = 0
    beacon_offset: int = 0


KINDS = ("disc", "cont", "rlwr")


def _paths(root: Path, cid: int) -> Path:
    return root / f"chall-id{cid:04d}"


@lru_cache(maxsize=64)
def _bound(m: int, q: int, svar: float, kind: str):
    """The instance bound of a challenge (the same for each instance): the
    tail bound on ||g e||^2 (discrete), or on the continuous error's sum of
    squares (G = I, no rounding slack)."""
    ctx = ring_context(m, (q,))
    if kind == "disc":
        return rlwe.gaussian_quad_bound(ctx, svar, gram="g")
    return float(rlwe.gaussian_quad_bound(ctx, svar, gram="id", rounded=False))


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def generate(root: Path, params: list[ChallengeParams], seed: int = 0, device=None) -> None:
    """Sample instances and secrets and write their files."""
    root, dev = Path(root), _device(device)
    g = torch.Generator().manual_seed(seed)
    for cp in params:
        if cp.kind not in KINDS:
            raise ValueError(f"unknown kind {cp.kind}")
        d = _paths(root, cp.challenge_id)
        d.mkdir(parents=True, exist_ok=True)
        ch = pb.Challenge(
            challenge_id=cp.challenge_id, m=cp.m, q=cp.q, svar=cp.svar,
            num_instances=cp.num_instances, kind=cp.kind, qprime=cp.qprime,
            beacon_epoch=cp.beacon_epoch, beacon_offset=cp.beacon_offset,
        )
        (d / "challenge.proto").write_bytes(ch.SerializeToString())
        ctx = ring_context(cp.m, (cp.q,))
        for iid in range(cp.num_instances):
            s_ints = sampling.gaussian_dec_ints(ctx, g, cp.svar, device="cpu").numpy()
            s = Cyc.from_ints(ctx, s_ints, device=dev)
            sec = pb.Secret(challenge_id=cp.challenge_id, instance_id=iid, m=cp.m,
                            s=ints_to_proto(cp.m, s_ints))
            (d / f"instance-{iid:03d}.secret").write_bytes(sec.SerializeToString())
            if cp.kind == "disc":
                samp = rlwe.sample_discrete(ctx, s, cp.svar, g)
                inst = pb.InstanceDisc(
                    challenge_id=cp.challenge_id, instance_id=iid,
                    a=cyc_to_proto(samp.a.to_crt()), b=cyc_to_proto(samp.b.to_crt()),
                    bound=_bound(cp.m, cp.q, cp.svar, "disc"))
            elif cp.kind == "cont":
                a, b = rlwe.sample_continuous(ctx, s, cp.svar, g)
                inst = pb.InstanceCont(
                    challenge_id=cp.challenge_id, instance_id=iid,
                    a=cyc_to_proto(a.to_crt()),
                    b=pb.Kq(m=cp.m, q=float(cp.q), coeffs=b.tolist()),
                    bound=_bound(cp.m, cp.q, cp.svar, "cont"))
            else:
                samp = rlwe.sample_rlwr(ctx, ring_context(cp.m, (cp.qprime,)), s, g)
                inst = pb.InstanceRLWR(challenge_id=cp.challenge_id, instance_id=iid,
                                       a=cyc_to_proto(samp.a.to_crt()), b=cyc_to_proto(samp.b))
            (d / f"instance-{iid:03d}.instance").write_bytes(inst.SerializeToString())


def _held_out(beacon: Beacon, ch: pb.Challenge) -> int:
    nbits = max(1, (int(ch.num_instances) - 1).bit_length())
    return beacon.bits(ch.beacon_epoch, ch.beacon_offset, nbits) % ch.num_instances


def suppress(root: Path, beacon: Beacon | None = None) -> None:
    """Delete the secret of each challenge's beacon-chosen instance (the
    one left hard); the others stay revealed for verification."""
    beacon = beacon or LocalBeacon()
    for d in sorted(Path(root).glob("chall-id*")):
        ch = pb.Challenge.FromString((d / "challenge.proto").read_bytes())
        keep = _held_out(beacon, ch)
        for f in sorted(d.glob("instance-*.secret")):
            if int(f.stem.split("-")[1]) == keep:
                f.unlink()


def verify(root: Path, beacon: Beacon | None = None, device=None) -> bool:
    """Check every revealed instance against its bound, and that the
    beacon's held-out instance has no secret."""
    beacon, dev = beacon or LocalBeacon(), _device(device)
    ok = True
    for d in sorted(Path(root).glob("chall-id*")):
        ch = pb.Challenge.FromString((d / "challenge.proto").read_bytes())
        keep = _held_out(beacon, ch)
        ctx = ring_context(int(ch.m), (int(ch.q),))
        for f in sorted(d.glob("instance-*.secret")):
            iid = int(f.stem.split("-")[1])
            if iid == keep:
                print(f"{d.name}: secret for held-out instance {iid} present "
                      "(suppress not run?)", file=sys.stderr)
                ok = False
                continue
            sec = pb.Secret.FromString(f.read_bytes())
            s = Cyc.from_ints(ctx, ints_from_proto(sec.s), device=dev)
            inst_f = d / f"instance-{iid:03d}.instance"
            if ch.kind == "disc":
                inst = pb.InstanceDisc.FromString(inst_f.read_bytes())
                samp = rlwe.RLWESample(cyc_from_proto(inst.a, dev), cyc_from_proto(inst.b, dev))
                if not rlwe.valid_instance(s, samp, bound=int(inst.bound)):
                    print(f"{d.name} inst {iid}: error bound violated", file=sys.stderr)
                    ok = False
            elif ch.kind == "cont":
                inst = pb.InstanceCont.FromString(inst_f.read_bytes())
                a = cyc_from_proto(inst.a, dev)
                b = torch.tensor(inst.b.coeffs, dtype=torch.float64, device=dev)
                # the centered lift (|v| < q/2) is exact in float64
                e = b - lift_centered(ctx, (a * s).to_dec().data).double()
                if float((e * e).sum()) > float(inst.bound):
                    print(f"{d.name} inst {iid}: continuous bound violated", file=sys.stderr)
                    ok = False
            elif ch.kind == "rlwr":
                inst = pb.InstanceRLWR.FromString(inst_f.read_bytes())
                ctx2 = ring_context(int(ch.m), (int(ch.qprime),))
                want = rlwe.sample_rlwr_recompute(ctx, ctx2, cyc_from_proto(inst.a, dev), s)
                got = cyc_from_proto(inst.b, dev)
                if got.rep is not Rep.DEC or not torch.equal(want.data, got.data):
                    print(f"{d.name} inst {iid}: RLWR rounding mismatch", file=sys.stderr)
                    ok = False
    return ok


def read_params(path) -> list[ChallengeParams]:
    """A params file: one challenge per line,
    `id m q svar num kind [qprime] [epoch] [offset]`, `#` comments."""
    params = []
    for line in Path(path).read_text().splitlines():
        parts = line.split("#")[0].split()
        if not parts:
            continue
        params.append(ChallengeParams(
            challenge_id=int(parts[0]), m=int(parts[1]), q=int(parts[2]),
            svar=float(parts[3]), num_instances=int(parts[4]), kind=parts[5],
            qprime=int(parts[6]) if len(parts) > 6 else 0,
            beacon_epoch=int(parts[7]) if len(parts) > 7 else 0,
            beacon_offset=int(parts[8]) if len(parts) > 8 else 0,
        ))
    return params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rlwe-challenges-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate")
    g.add_argument("root")
    g.add_argument("--params", required=True,
                   help="params file: one challenge per line: "
                        "id m q svar num kind [qprime] [epoch] [offset]")
    g.add_argument("--seed", type=int, default=0)
    s = sub.add_parser("suppress")
    s.add_argument("root")
    s.add_argument("--beacon-records", default=None,
                   help="directory of pre-fetched NIST beacon records "
                        "(<epoch>.xml v1 / <epoch>.json v2); default: "
                        "offline LocalBeacon")
    v = sub.add_parser("verify")
    v.add_argument("root")
    v.add_argument("--beacon-records", default=None)
    for p in (g, v):
        p.add_argument("--device", default=None,
                       help="torch device of the ring work (default: the card)")
    args = ap.parse_args(argv)

    def _beacon():
        from .beacon import NistRecordBeacon

        rec = getattr(args, "beacon_records", None)
        return NistRecordBeacon(rec) if rec else None

    if args.cmd == "generate":
        params = read_params(args.params)
        generate(Path(args.root), params, seed=args.seed, device=args.device)
        print(f"generated {len(params)} challenges under {args.root}")
        return 0
    if args.cmd == "suppress":
        suppress(Path(args.root), beacon=_beacon())
        print("suppressed")
        return 0
    ok = verify(Path(args.root), beacon=_beacon(), device=args.device)
    print("verify:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
