"""The port's serialization (`proto.wire`, `io`) against the JAX package's.

`proto.wire` holds the 16 messages of `lol.proto` without a protobuf
runtime: its field tables are the generated descriptor's, and its bytes
are the generated bindings' for every message type, on random content
with the edge values (a -0.0 double, a negative int64, the largest
uint64 / sint64, empty and absent fields); each side parses the other's
bytes, and the port also reads unpacked repeated scalars and skips
unknown fields.  `io` round-trips every object of the port on the CPU,
writes the bytes the JAX package writes for the same object (keys,
ciphertexts LSD / MSD, linear maps, key-switch hints under the three
gadgets, extended-modulus, tunnel, rounding and HomomPRF hints), and a
hint written by either package key-switches in the other to its own
result, bit for bit, at m = 32 over three 30-bit primes.
"""

import math
import struct
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from google.protobuf.descriptor import FieldDescriptor as FD

from lol_tpu import gadget as jgd
from lol_tpu import io as jio
from lol_tpu import linear as jlinear
from lol_tpu import prf as jprf
from lol_tpu import she as jshe
from lol_tpu.cyc import Cyc as JCyc
from lol_tpu.proto import lol_pb2 as jpb
from lol_tpu.ring import ring_context as j_ring_context
from lol_tpu_torch import prng
from lol_tpu_torch import convert, gadget as gd, io, linear, numtheory as nt, prf, she
from lol_tpu_torch.cyc import Cyc, Rep
from lol_tpu_torch.proto import wire as pb
from lol_tpu_torch.ring import ring_context
from lol_tpu_torch.she_batched import BatchedBGV

torch.set_num_threads(2)

M, MS = 32, 16
QS = tuple(nt.ntt_primes(64, 30, 3))
SPECIAL = tuple(nt.ntt_primes(64, 30, 5)[3:])
BASE = 1 << 16
P8_QS = tuple(nt.ntt_primes(32, 30, she.pt_round_mults(8) + 2))
TYPES = {FD.TYPE_UINT64: "uint64", FD.TYPE_UINT32: "uint32", FD.TYPE_INT64: "int64",
         FD.TYPE_SINT64: "sint64", FD.TYPE_DOUBLE: "double", FD.TYPE_STRING: "string",
         FD.TYPE_BYTES: "bytes"}
EDGES = {"uint64": [0, 1, 127, 128, 300, 2 ** 63, 2 ** 64 - 1],
         "uint32": [0, 1, 128, 2 ** 31, 2 ** 32 - 1],
         "int64": [0, 1, -1, -(2 ** 63), 2 ** 63 - 1, -1400000000],
         "sint64": [0, 1, -1, 63, -64, -(2 ** 63), 2 ** 63 - 1],
         "double": [0.0, -0.0, 1.5, -3.25, 1e-300, float("inf"), -float("inf")],
         "string": ["", "crt", "base:65536", "hé"],
         "bytes": [b"", b"\x00", bytes(range(256))]}


# --- the wire codec -----------------------------------------------------------


def _repeated(f) -> bool:
    return f.is_repeated if hasattr(f, "is_repeated") else f.label == FD.LABEL_REPEATED


def test_wire_field_tables_match_the_descriptor():
    """Every message's (name, number, type, repeated) == lol_pb2.DESCRIPTOR's."""
    assert sorted(c.__name__ for c in pb.MESSAGES) == sorted(jpb.DESCRIPTOR.message_types_by_name)
    for cls in pb.MESSAGES:
        d = jpb.DESCRIPTOR.message_types_by_name[cls.__name__]
        mine = sorted((f.name, f.number, f.type.__name__ if f.is_message else f.type, f.repeated)
                      for f in cls.FIELDS)
        theirs = sorted((f.name, f.number,
                         f.message_type.name if f.type == FD.TYPE_MESSAGE else TYPES[f.type],
                         _repeated(f)) for f in d.fields)
        assert mine == theirs, cls.__name__


def _content(cls, rng, depth=0):
    """Random content for a message (the same for both packages): each
    field absent one time in five, edge values and random ones."""
    mine, theirs = {}, {}
    for f in cls.FIELDS:
        if rng.random() < 0.2:
            continue
        if f.is_message:
            subs = [_content(f.type, rng, depth + 1)
                    for _ in range(int(rng.integers(0, 3)) if f.repeated else 1)]
            mine[f.name] = [s[0] for s in subs] if f.repeated else subs[0][0]
            theirs[f.name] = [s[1] for s in subs] if f.repeated else subs[0][1]
            continue
        edges = EDGES[f.type]
        vals = [edges[int(rng.integers(len(edges)))] if rng.random() < 0.7 else
                {"double": float(rng.normal()), "string": "x" * int(rng.integers(200)),
                 "bytes": rng.bytes(int(rng.integers(300))), "uint32": int(rng.integers(1 << 32))
                 }.get(f.type, int(rng.integers(1 << 40)))
                for _ in range(int(rng.integers(0, 5)) if f.repeated else 1)]
        mine[f.name] = theirs[f.name] = vals if f.repeated else vals[0]
    return cls(**mine), getattr(jpb, cls.__name__)(**theirs)


@pytest.mark.parametrize("name", [c.__name__ for c in pb.MESSAGES])
def test_wire_bytes_equal_the_generated_bindings(name):
    """The port's bytes == SerializeToString() of the same content; the
    generated parser reads the port's bytes back to that content, and the
    port reads the generated bytes to bytes it writes identically."""
    cls, rng = getattr(pb, name), np.random.default_rng(sum(map(ord, name)))
    for _ in range(60):
        mine, theirs = _content(cls, rng)
        want = theirs.SerializeToString()
        assert mine.SerializeToString() == want
        assert getattr(jpb, name).FromString(mine.SerializeToString()) == theirs
        back = cls.FromString(want)
        assert back == mine and back.SerializeToString() == want


def _varint(v):
    out = bytearray()
    while v > 0x7F:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    return bytes(out + bytes([v]))


def test_wire_reads_unpacked_scalars_and_skips_unknown_fields():
    """A proto3 parser's leniency: repeated scalars one element a field
    (mixed with packed runs), unknown fields of every wire type skipped,
    an absent sub-message None and HasField False."""
    data = (_varint(1 << 3) + _varint(64)                             # m = 64
            + _varint(2 << 3) + _varint(7)                            # qs: one unpacked
            + _varint(99 << 3 | 2) + _varint(3) + b"abc"              # unknown, length-delimited
            + _varint(2 << 3 | 2) + _varint(2) + _varint(8) + _varint(9)  # qs: packed run
            + _varint(98 << 3) + _varint(2 ** 40)                     # unknown varint
            + _varint(97 << 3 | 1) + struct.pack("<d", 1.0)           # unknown fixed64
            + _varint(96 << 3 | 5) + b"\x00" * 4                      # unknown fixed32
            + _varint(3 << 3 | 2) + _varint(3) + b"crt")
    msg = pb.Rq.FromString(data)
    assert (msg.m, msg.qs, msg.rep, msg.coeffs) == (64, [7, 8, 9], "crt", b"")
    assert jpb.Rq.FromString(data).qs == [7, 8, 9]
    kq = pb.Kq.FromString(b"".join(_varint(3 << 3 | 1) + struct.pack("<d", v) for v in (1.5, -2.0)))
    assert kq.coeffs == [1.5, -2.0]
    r = pb.R.FromString(_varint(2 << 3) + _varint(3) + _varint(2 << 3) + _varint(4))
    assert r.coeffs == [-2, 2]  # zigzag
    eh = pb.EvalHints.FromString(pb.EvalHints(p_final=2).SerializeToString())
    assert eh.rounds is None and not eh.HasField("rounds") and eh.tunnels == []
    assert pb.EvalHints(rounds=pb.PTRoundHints()).SerializeToString() == \
        jpb.EvalHints(rounds=jpb.PTRoundHints()).SerializeToString() == b"\x1a\x00"


def test_wire_refuses_what_it_cannot_write_or_read():
    with pytest.raises(ValueError, match="out of range"):
        pb.Challenge(challenge_id=1 << 32).SerializeToString()
    with pytest.raises(ValueError, match="out of range"):
        pb.Rq(qs=[-1]).SerializeToString()
    with pytest.raises(ValueError, match="no field"):
        pb.Rq(bogus=1)
    with pytest.raises(ValueError):
        pb.Rq.FromString(_varint(4 << 3 | 2) + _varint(10) + b"abc")  # runs past the end
    with pytest.raises(ValueError, match="truncated"):
        pb.Rq.FromString(b"\x08\x80")


# --- io: the objects ------------------------------------------------------------


def _params(jp):
    return she.SHEParams(m=jp.m, p=jp.p, qs=tuple(jp.qs), var=jp.var)


@pytest.fixture(scope="module")
def st():
    """The JAX package's objects at m = 32 (and 16, 8)."""
    rng = np.random.default_rng(0)
    k = iter(jax.random.split(jax.random.PRNGKey(11), 20))
    jp = jshe.SHEParams(m=M, p=257, qs=QS, var=2.0)
    jsk = jshe.gen_sk(jp, next(k))
    m1, m2 = jshe.pt_random(jp, rng), jshe.pt_random(jp, rng)
    out = dict(jp=jp, jsk=jsk, m1=m1, a=jshe.encrypt(jsk, m1, next(k)),
               b=jshe.encrypt(jsk, m2, next(k)), msd=jshe.encrypt_msd(jsk, m1, next(k)))
    for tag, spec in (("rns", jgd.RnsGad()), ("base", jgd.BaseBGad(BASE)), ("triv", jgd.TrivGad())):
        out[f"quad_{tag}"] = jshe.ks_quad_circ_hint(jsk, spec, next(k))
    out["quad_ext"] = jshe.ks_quad_circ_hint_ext(jsk, jgd.RnsGad(), next(k), SPECIAL)
    jps = jshe.SHEParams(m=MS, p=257, qs=QS, var=2.0)
    out["jsk_s"] = jshe.gen_sk(jps, next(k))
    S, R = j_ring_context(MS, QS), j_ring_context(M, QS)
    jf = jlinear.linear_pow(S, R, S, [JCyc.from_ints(S, rng.integers(-2, 3, MS // 2))
                                      for _ in range(2)])
    out["lin"] = jf
    out["tunnel"] = jshe.tunnel_hint(jf, out["jsk_s"], jsk, jgd.RnsGad(), next(k))
    rings = [16, 8]
    jsks = [jshe.gen_sk(jshe.SHEParams(m=r, p=8, qs=P8_QS, var=2.0), next(k)) for r in rings]
    out["rounds"] = jshe.pt_round_hints(jsks[-1], jgd.RnsGad(), next(k))
    for tag, rnd in (("eval", False), ("eval_rounds", True)):
        out[tag] = jprf.make_eval_hints(None, jsks, rings, rings[1:], jgd.RnsGad(), next(k),
                                        homomorphic_round=rnd, maps="project")[0]
    return out


# (io name, JAX object key): every message io writes, from the JAX package's objects
OBJECTS = [("sk", "jsk"), ("ct", "a"), ("ct", "msd"), ("linear", "lin"),
           ("ks_hint", "quad_rns"), ("ks_hint", "quad_base"), ("ks_hint", "quad_triv"),
           ("ks_hint_ext", "quad_ext"), ("tunnel_hint", "tunnel"),
           ("pt_round_hints", "rounds"), ("eval_hints", "eval"), ("eval_hints", "eval_rounds")]
MESSAGE = {"sk": "SecretKey", "ct": "SHECiphertext", "linear": "LinearRq", "ks_hint": "KSHint",
           "ks_hint_ext": "KSHintExt", "tunnel_hint": "TunnelHint",
           "pt_round_hints": "PTRoundHints", "eval_hints": "EvalHints"}


@pytest.mark.parametrize("kind,key", OBJECTS, ids=[k for _, k in OBJECTS])
def test_io_reads_and_writes_the_jax_packages_bytes(st, kind, key):
    """The port reads the JAX package's bytes of an object and writes them
    back identically; the JAX package reads the port's bytes to bytes it
    writes identically."""
    want = getattr(jio, f"{kind}_to_proto")(st[key]).SerializeToString()
    msg = getattr(pb, MESSAGE[kind]).FromString(want)
    obj = getattr(io, f"{kind}_from_proto")(msg, device="cpu")
    mine = getattr(io, f"{kind}_to_proto")(obj).SerializeToString()
    assert mine == want
    jback = getattr(jio, f"{kind}_from_proto")(getattr(jpb, MESSAGE[kind]).FromString(mine))
    assert getattr(jio, f"{kind}_to_proto")(jback).SerializeToString() == want


def _same_tensors(a, b):
    """Two port objects (dataclasses of tensors, arrays, Cycs and tuples of
    them) hold equal values."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tensors(x, y)
    elif isinstance(a, Cyc):
        assert a.ctx == b.ctx and a.rep is b.rep
        _same_tensors(a.data, b.data)
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a) is type(b)
        for name in a.__dataclass_fields__:
            _same_tensors(getattr(a, name), getattr(b, name))
    else:
        assert a == b


@pytest.fixture(scope="module")
def port_objects():
    """The port's own objects at m = 32 (and 16, 8), made on the CPU."""
    g, rng = prng.KeyChain(5), np.random.default_rng(5)
    params = she.SHEParams(m=M, p=257, qs=QS, var=2.0)
    sk = she.gen_sk(params, g(), "cpu")
    m1 = she.pt_random(params, rng, device="cpu").numpy()
    out = {"sk": sk, "ct": she.encrypt(sk, m1, g(), "cpu"), "ct_msd": she.encrypt_msd(sk, m1, g(), "cpu")}
    for tag, spec in (("rns", gd.RnsGad()), ("base", gd.BaseBGad(BASE)), ("triv", gd.TrivGad())):
        out[f"ks_{tag}"] = she.ks_quad_circ_hint(sk, spec, g(), "cpu")
    out["ks_ext"] = she.ks_quad_circ_hint_ext(sk, gd.RnsGad(), g(), SPECIAL, "cpu")
    S = ring_context(MS, QS)
    out["linear"] = linear.linear_pow(S, params.ctx, S, [[1] + [0] * 7, [0, -3, 2] + [0] * 5])
    sk_s = she.gen_sk(replace(params, m=MS), g(), "cpu")
    out["tunnel"] = BatchedBGV(params, "cpu").gen_tunnel_hint(out["linear"], sk_s, sk, g())
    rings = [16, 8]
    sks = [she.gen_sk(she.SHEParams(m=r, p=8, qs=P8_QS, var=2.0), g(), "cpu") for r in rings]
    out["rounds"] = she.pt_round_hints(sks[-1], gd.RnsGad(), g(), "cpu")
    for tag, rnd in (("eval", False), ("eval_rounds", True)):
        out[tag] = prf.make_eval_hints(None, sks, rings, rings[1:], gd.RnsGad(), g(), homomorphic_round=rnd,
                                       maps="project", device="cpu")[0]
    return out


PORT = [("sk", "sk"), ("ct", "ct"), ("ct", "ct_msd"), ("linear", "linear"),
        ("ks_hint", "ks_rns"), ("ks_hint", "ks_base"), ("ks_hint", "ks_triv"),
        ("ks_hint_ext", "ks_ext"), ("tunnel_hint", "tunnel"), ("pt_round_hints", "rounds"),
        ("eval_hints", "eval"), ("eval_hints", "eval_rounds")]


@pytest.mark.parametrize("kind,key", PORT, ids=[k for _, k in PORT])
def test_io_round_trips_the_ports_objects(port_objects, kind, key):
    """to_proto -> bytes -> from_proto(device="cpu") gives the same object
    (every tensor, gadget, chain and flag), which writes the same bytes.
    (A ciphertext's message carries no error variance, in either package:
    it reads back with the default.)"""
    obj = port_objects[key]
    if kind == "ct":
        obj = replace(obj, params=replace(obj.params, var=she.SHEParams.var))
    data = getattr(io, f"{kind}_to_proto")(obj).SerializeToString()
    back = getattr(io, f"{kind}_from_proto")(getattr(pb, MESSAGE[kind]).FromString(data),
                                             device="cpu")
    _same_tensors(back, obj)
    assert getattr(io, f"{kind}_to_proto")(back).SerializeToString() == data
    if kind == "eval_hints":
        assert (back.rounds is None) == (key == "eval")


def test_cyc_round_trip_and_refusals():
    ctx = ring_context(M, QS)
    x = Cyc.from_ints(ctx, np.arange(-8, 8), device="cpu").to_crt()
    back = io.cyc_from_proto(pb.Rq.FromString(io.cyc_to_proto(x).SerializeToString()), "cpu")
    assert back.rep is Rep.CRT and back == x
    with pytest.raises(ValueError, match="single elements"):
        io.cyc_to_proto(Cyc(ctx, Rep.POW, torch.zeros((2, 3, 16), dtype=torch.int32)))
    bad = io.cyc_to_proto(x)
    bad.coeffs = np.full((3, 16), QS[0], dtype="<u4").tobytes()
    with pytest.raises(ValueError, match="at or above"):
        io.cyc_from_proto(bad, "cpu")
    bad.coeffs = bad.coeffs[:-4]
    with pytest.raises(ValueError, match="residues"):
        io.cyc_from_proto(bad, "cpu")
    with pytest.raises(ValueError, match="gadget"):
        io._gad_from_str("nope")


def test_rows_in_another_representation_are_converted_on_read(port_objects):
    """A hint row or a linear image written in another representation
    reads as the same element: hint rows come back as CRT stacks, images
    as their powerful-basis coefficients."""
    h = port_objects["ks_rns"]
    msg = io.ks_hint_to_proto(h)
    ctx = h.ctx
    msg.h0 = [io.cyc_to_proto(Cyc(ctx, Rep.CRT, h.h0[j]).to_pow()) for j in range(h.h0.shape[0])]
    msg.h1 = [io.cyc_to_proto(Cyc(ctx, Rep.CRT, h.h1[j]).to_dec()) for j in range(h.h1.shape[0])]
    _same_tensors(io.ks_hint_from_proto(pb.KSHint.FromString(msg.SerializeToString()), "cpu"), h)
    lin = port_objects["linear"]
    msg = io.linear_to_proto(lin)
    msg.ys = [io.cyc_to_proto(Cyc.from_ints(lin.s_ctx, y, device="cpu").to_crt()) for y in lin.ys]
    _same_tensors(io.linear_from_proto(msg, "cpu"), lin)


# --- hints across the packages, functionally ----------------------------------


def _ct(jct):
    return convert.ct_from_numpy(_params(jct.params), [(c.rep.value, np.asarray(c.data))
                                                      for c in jct.cs],
                                 jct.f, jct.encoding, device="cpu")


def _same_ct(ct, jct):
    assert (ct.f, ct.encoding, ct.ctx.m, ct.ctx.basis.qs) == \
        (jct.f, jct.encoding, jct.ctx.m, tuple(jct.ctx.basis.qs))
    for c, jc in zip(ct.cs, jct.cs):
        assert c.rep.value == jc.rep.value
        np.testing.assert_array_equal(c.data.numpy().astype(np.int64),
                                      np.asarray(jc.data).astype(np.int64))


def _via_bytes(kind, jobj):
    data = getattr(jio, f"{kind}_to_proto")(jobj).SerializeToString()
    return getattr(io, f"{kind}_from_proto")(getattr(pb, MESSAGE[kind]).FromString(data), "cpu")


@pytest.mark.parametrize("tag", ["rns", "base", "triv"])
def test_jax_written_hint_key_switches_in_the_port_bit_for_bit(st, tag):
    """The JAX package's relinearization hint, written by it and read by
    the port, relinearizes the product to the JAX package's ciphertext."""
    jprod = jshe.ct_mul(st["a"], st["b"])
    want = jshe.key_switch_quad_circ(st[f"quad_{tag}"], jprod)
    hint = _via_bytes("ks_hint", st[f"quad_{tag}"])
    _same_ct(she.key_switch_quad_circ(hint, she.ct_mul(_ct(st["a"]), _ct(st["b"]))), want)


def test_jax_written_ext_and_tunnel_hints_work_in_the_port(st):
    """The extended-modulus hint and the tunnel hint likewise; the port's
    batched step on the reloaded RNS hint decrypts to the product."""
    jprod = jshe.ct_mul(st["a"], st["b"])
    _same_ct(she.key_switch_quad_circ_ext(_via_bytes("ks_hint_ext", st["quad_ext"]),
                                          she.ct_mul(_ct(st["a"]), _ct(st["b"]))),
             jshe.key_switch_quad_circ_ext(st["quad_ext"], jprod))
    _same_ct(she.tunnel(_via_bytes("tunnel_hint", st["tunnel"]), _ct(st["a"])),
             jshe.tunnel(st["tunnel"], st["a"]))
    params = _params(st["jp"])
    bb = BatchedBGV(params, "cpu")
    hint = _via_bytes("ks_hint", st["quad_rns"])
    e0, e1 = bb.build_step(hint)(*bb.pack([_ct(st["a"])]), *bb.pack([_ct(st["b"])]))
    p2 = replace(params, qs=params.qs[:-1])
    sk = convert.sk_from_numpy(p2, st["jsk"].s_ints)
    got = BatchedBGV(p2, "cpu").build_decrypt(sk, f=bb.step_f())(e0, e1)
    np.testing.assert_array_equal(got[:, 0].numpy(), jshe.decrypt(
        st["jsk"], jshe.key_switch_quad_circ(st["quad_rns"], jshe.ct_mul(st["a"], st["b"]))))


def test_port_written_hint_key_switches_in_jax_bit_for_bit(st):
    """The port's hint for the JAX package's key, written by the port and
    read by the JAX package, relinearizes there to the port's ciphertext."""
    params = _params(st["jp"])
    sk = convert.sk_from_numpy(params, st["jsk"].s_ints)
    hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), prng.PRNGKey(9), "cpu")
    jhint = jio.ks_hint_from_proto(jpb.KSHint.FromString(
        io.ks_hint_to_proto(hint).SerializeToString()))
    want = jshe.key_switch_quad_circ(jhint, jshe.ct_mul(st["a"], st["b"]))
    _same_ct(she.key_switch_quad_circ(hint, she.ct_mul(_ct(st["a"]), _ct(st["b"]))), want)
    np.testing.assert_array_equal(jshe.decrypt(st["jsk"], want),
                                  jshe.decrypt(st["jsk"], jshe.ct_mul(st["a"], st["b"])))
    assert math.isfinite(float(jhint.params.var))
