"""The port's RLWE challenges (`challenges/`) against the JAX package's.

Mirrors `tests/test_io_challenges.py`: a directory generated by either
package is suppressed and verified by the other (disc, cont and rlwr
challenges at m = 64, and disc at the general ring m = 72); verify flags
a held-out secret that is still present, a corrupted secret, an instance
whose error was moved past its bound, and a restored held-out secret;
the CLI runs its three phases; `NistRecordBeacon` reads v1 and v2
records and refuses a forged one; and the port's generate names one
directory per seed.
"""

import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from lol_tpu import challenges as jch
from lol_tpu.challenges import driver as jdriver
from lol_tpu_torch import io, numtheory as nt
from lol_tpu_torch.challenges import ChallengeParams, LocalBeacon, generate, main, suppress, verify
from lol_tpu_torch.challenges.beacon import NistRecordBeacon
from lol_tpu_torch.cyc import Cyc
from lol_tpu_torch.proto import wire as pb

torch.set_num_threads(2)

Q64 = nt.ntt_primes(64, 30, 1)[0]
Q72 = nt.ntt_primes(72, 30, 1)[0]


def _params(pkg):
    P = pkg.ChallengeParams if pkg is not None else ChallengeParams
    return [P(0, 64, Q64, 4.0, 3, "disc", beacon_epoch=11, beacon_offset=0),
            P(1, 64, Q64, 4.0, 2, "cont", beacon_epoch=12, beacon_offset=8),
            P(2, 64, Q64, 4.0, 2, "rlwr", qprime=257, beacon_epoch=13),
            P(3, 72, Q72, 4.0, 2, "disc", beacon_epoch=14)]


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_chall")
    jch.generate(root, _params(jdriver), seed=7)
    return root


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_chall")
    generate(root, _params(None), seed=7, device="cpu")
    return root


def _copy(src, tmp_path):
    dst = tmp_path / "c"
    shutil.copytree(src, dst)
    return dst


def test_jax_directory_suppressed_and_verified_by_the_port(jax_dir, tmp_path):
    root = _copy(jax_dir, tmp_path)
    dirs = sorted(root.glob("chall-id*"))
    assert len(dirs) == 4 and len(list(dirs[0].glob("*.secret"))) == 3
    assert verify(root, device="cpu") is False  # the held-out secret is still there
    suppress(root)
    assert [len(list(d.glob("*.secret"))) for d in dirs] == [2, 1, 1, 1]
    assert verify(root, device="cpu") is True
    assert jch.verify(root) is True


def test_port_directory_suppressed_and_verified_by_jax(port_dir, tmp_path):
    root = _copy(port_dir, tmp_path)
    assert jch.verify(root) is False
    jch.suppress(root)
    assert jch.verify(root) is True
    assert verify(root, device="cpu") is True


def test_port_files_are_the_schema_the_jax_package_reads(port_dir):
    """Every file parses with the generated bindings and re-serializes to
    the same bytes; the instances' elements lie in their rings."""
    from lol_tpu.proto import lol_pb2 as jpb

    kinds = {"challenge.proto": "Challenge", ".secret": "Secret"}
    inst = {"disc": "InstanceDisc", "cont": "InstanceCont", "rlwr": "InstanceRLWR"}
    for d in sorted(port_dir.glob("chall-id*")):
        ch = pb.Challenge.FromString((d / "challenge.proto").read_bytes())
        for f in sorted(d.iterdir()):
            name = kinds.get(f.name) or kinds.get(f.suffix) or inst[ch.kind]
            data = f.read_bytes()
            assert getattr(jpb, name).FromString(data).SerializeToString() == data
            assert getattr(pb, name).FromString(data).SerializeToString() == data
    a = pb.InstanceDisc.FromString((port_dir / "chall-id0003" / "instance-000.instance")
                                   .read_bytes()).a
    assert io.cyc_from_proto(a, "cpu").ctx.m == 72


def _suppressed(src, tmp_path):
    root = _copy(src, tmp_path)
    suppress(root)
    assert verify(root, device="cpu") is True
    return root


def test_verify_catches_a_corrupted_secret(port_dir, tmp_path):
    root = _suppressed(port_dir, tmp_path)
    f = sorted(root.glob("chall-id0000/*.secret"))[0]
    sec = pb.Secret.FromString(f.read_bytes())
    sec.s.coeffs[0] += 1000
    f.write_bytes(sec.SerializeToString())
    assert verify(root, device="cpu") is False
    assert jch.verify(root) is False


@pytest.mark.parametrize("cid", [0, 3])
def test_verify_catches_an_error_past_its_bound(port_dir, tmp_path, cid):
    """One disc instance's b moved by q / 2 in one decoding coefficient
    (written back in the CRT basis): its error leaves the bound."""
    root = _suppressed(port_dir, tmp_path)
    d = root / f"chall-id{cid:04d}"
    iid = int(sorted(d.glob("*.secret"))[0].stem.split("-")[1])
    f = d / f"instance-{iid:03d}.instance"
    inst = pb.InstanceDisc.FromString(f.read_bytes())
    b = io.cyc_from_proto(inst.b, "cpu")
    bump = np.zeros(b.ctx.n, dtype=np.int64)
    bump[0] = b.ctx.basis.qs[0] // 2
    inst.b = io.cyc_to_proto((b.to_dec() + Cyc.from_ints(b.ctx, bump, device="cpu")).to_crt())
    f.write_bytes(inst.SerializeToString())
    assert verify(root, device="cpu") is False
    assert jch.verify(root) is False


def test_verify_catches_a_restored_held_out_secret(port_dir, tmp_path):
    root = _suppressed(port_dir, tmp_path)
    d = root / "chall-id0001"
    ch = pb.Challenge.FromString((d / "challenge.proto").read_bytes())
    keep = LocalBeacon().bits(ch.beacon_epoch, ch.beacon_offset, 1) % ch.num_instances
    name = f"instance-{keep:03d}.secret"
    shutil.copy(port_dir / "chall-id0001" / name, d / name)
    assert verify(root, device="cpu") is False


def test_cli_runs_its_three_phases(tmp_path, capsys):
    pfile = tmp_path / "params.txt"
    pfile.write_text(f"# id m q svar num kind\n0 64 {Q64} 4.0 2 disc\n"
                     f"1 64 {Q64} 4.0 2 rlwr 257 5 3\n")
    root = tmp_path / "out"
    assert main(["generate", str(root), "--params", str(pfile), "--device", "cpu"]) == 0
    assert main(["suppress", str(root)]) == 0
    assert main(["verify", str(root), "--device", "cpu"]) == 0
    assert "verify: OK" in capsys.readouterr().out
    ch = pb.Challenge.FromString((root / "chall-id0001" / "challenge.proto").read_bytes())
    assert (ch.kind, ch.qprime, ch.beacon_epoch, ch.beacon_offset) == ("rlwr", 257, 5, 3)
    # an epoch whose beacon holds out the other instance: its secret is revealed
    epoch = next(e for e in range(1, 64) if LocalBeacon().bits(e, 0, 1) != LocalBeacon().bits(0, 0, 1))
    (root / "chall-id0000" / "challenge.proto").write_bytes(pb.Challenge(
        challenge_id=0, m=64, q=Q64, svar=4.0, num_instances=2, kind="disc",
        beacon_epoch=epoch).SerializeToString())
    assert main(["verify", str(root), "--device", "cpu"]) == 1
    assert "verify: FAILED" in capsys.readouterr().out


def test_generate_is_deterministic_in_its_seed(port_dir, tmp_path):
    """The same seed writes byte-identical files; another seed others."""
    generate(tmp_path / "again", _params(None), seed=7, device="cpu")
    generate(tmp_path / "other", _params(None), seed=8, device="cpu")
    files = sorted(p.relative_to(port_dir) for p in port_dir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "again")
                           for p in (tmp_path / "again").rglob("*") if p.is_file())
    same = [(port_dir / f).read_bytes() == (tmp_path / "again" / f).read_bytes() for f in files]
    assert all(same)
    assert any((port_dir / f).read_bytes() != (tmp_path / "other" / f).read_bytes()
               for f in files if f.suffix == ".secret")
    with pytest.raises(ValueError, match="unknown kind"):
        generate(tmp_path / "bad", [ChallengeParams(0, 64, Q64, 4.0, 1, "lwe")], device="cpu")


def _write_v1_record(d, epoch: int, sig: bytes):
    out = hashlib.sha512(sig).hexdigest().upper()
    (d / f"{epoch}.xml").write_text(
        "<record xmlns=\"http://beacon.nist.gov/record/0.1/\">"
        f"<timeStamp>{epoch}</timeStamp>"
        f"<signatureValue>{sig.hex().upper()}</signatureValue>"
        f"<outputValue>{out}</outputValue></record>")
    return bytes.fromhex(out)


def test_nist_record_beacon_v1_and_v2(tmp_path):
    want = _write_v1_record(tmp_path, 1400000000, bytes(range(256)))
    out2 = hashlib.sha512(b"pulse").hexdigest()
    (tmp_path / "1500000000.json").write_text(
        json.dumps({"pulse": {"timeStamp": "t", "outputValue": out2}}))
    b = NistRecordBeacon(tmp_path)
    assert b.record(1400000000) == want
    assert b.record(1500000000) == bytes.fromhex(out2)
    assert b.bits(1400000000, 0, 8) == want[0]
    assert b.bits(1400000000, 4, 8) == jch.beacon.NistRecordBeacon(tmp_path).bits(1400000000, 4, 8)
    with pytest.raises(FileNotFoundError):
        b.record(1234)
    with pytest.raises(ValueError, match="beyond record"):
        b.bits(1400000000, 510, 8)


def test_nist_record_beacon_detects_corruption(tmp_path):
    good = _write_v1_record(tmp_path, 99, b"\x01" * 64).hex().upper()
    f = tmp_path / "99.xml"
    f.write_text(f.read_text().replace(good, hashlib.sha512(b"forged").hexdigest().upper()))
    with pytest.raises(ValueError, match="forged"):
        NistRecordBeacon(tmp_path).record(99)
    assert NistRecordBeacon(tmp_path, verify_chain=False).record(99)


def test_suppress_and_verify_with_a_nist_beacon(tmp_path):
    recs, recs2 = tmp_path / "records", tmp_path / "records2"
    recs.mkdir()
    recs2.mkdir()
    _write_v1_record(recs, 42, b"beacon-sig")
    _write_v1_record(recs2, 42, b"other-sig")
    generate(tmp_path / "out", [ChallengeParams(0, 64, Q64, 4.0, 3, "disc", beacon_epoch=42)],
             seed=3, device="cpu")
    b, b2 = NistRecordBeacon(recs), NistRecordBeacon(recs2)
    suppress(tmp_path / "out", beacon=b)
    assert len(list((tmp_path / "out" / "chall-id0000").glob("*.secret"))) == 2
    assert verify(tmp_path / "out", beacon=b, device="cpu") is True
    assert main(["verify", str(tmp_path / "out"), "--beacon-records", str(recs),
                 "--device", "cpu"]) == 0
    if b.bits(42, 0, 2) % 3 != b2.bits(42, 0, 2) % 3:
        assert verify(tmp_path / "out", beacon=b2, device="cpu") is False


@pytest.mark.parametrize("m", [64, 72, 18432, 32768])
def test_verify_norm_is_the_exact_host_norm(m):
    """`ring.gsq_norm_dec`, the norm verify takes on the tensor's device
    (15-bit limbs, int64 sums), == the exact host norm and the JAX
    package's, on small errors and on residues that span the modulus."""
    from lol_tpu import ring as jring
    from lol_tpu_torch import ring as rg
    from lol_tpu_torch.ring import ring_context

    q = nt.ntt_primes(m, 30, 1)[0]
    ctx = ring_context(m, (q,))
    rng = np.random.default_rng(m)
    for hi in (9, q):
        x = rng.integers(0, hi, (2, 1, ctx.n))
        x[0, 0, :3] = [q - 1, (q - 1) // 2, (q + 1) // 2] if hi == q else x[0, 0, :3]
        t = torch.from_numpy(x.astype(np.int32))
        got = rg.gsq_norm_dec(ctx, t)
        assert got.shape == (2,) and (got == rg.gsq_norm_dec_host(ctx, t)).all()
        if m <= 72:
            jctx = jring.ring_context(m, (q,))
            assert (got == jring.gsq_norm_dec_host(jctx, x.astype(np.uint32))).all()
