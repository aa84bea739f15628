"""The protobuf wire format of `lol.proto`'s 16 messages, in plain Python.

Counterpart of the JAX package's generated `lol_pb2.py`, without
`google.protobuf`: each message is a small class under the generated
name (`Rq`, `KSHint`, `Challenge`, ...) with keyword construction,
`SerializeToString()`, `FromString()` and `HasField()`.  Its `FIELDS`
table is the schema's: name, field number, type, and whether the field
is repeated.

Writing gives the generated bindings' bytes: fields in field-number
order, proto3 defaults omitted (a double is omitted only at +0.0),
repeated scalars packed, and an absent sub-message omitted.  Reading
accepts packed and unpacked repeated scalars and skips unknown fields,
as any proto3 parser does.  An absent sub-message reads as None.

Scalar types: uint64 / uint32 / int64 (varints, an int64 below 0 as its
ten-byte two's complement), sint64 (zigzag varints), double (fixed64),
string, bytes.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

VARINT, I64, LEN = 0, 1, 2
_U64 = (1 << 64) - 1
_RANGES = {"uint64": (0, _U64), "uint32": (0, (1 << 32) - 1),
           "int64": (-(1 << 63), (1 << 63) - 1), "sint64": (-(1 << 63), (1 << 63) - 1)}
_WIRE = {"uint64": VARINT, "uint32": VARINT, "int64": VARINT, "sint64": VARINT,
         "double": I64, "string": LEN, "bytes": LEN}
_DEFAULT = {"uint64": 0, "uint32": 0, "int64": 0, "sint64": 0, "double": 0.0,
            "string": "", "bytes": b""}
_F64 = struct.Struct("<d")


class Field(NamedTuple):
    name: str
    number: int
    type: object  # a scalar type's name, or a Message subclass
    repeated: bool = False

    @property
    def is_message(self) -> bool:
        return not isinstance(self.type, str)

    @property
    def wire_type(self) -> int:
        return LEN if self.is_message else _WIRE[self.type]


# --- primitives ---------------------------------------------------------------


def _put_varint(out: bytearray, v: int) -> None:
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _get_varint(buf, pos: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("wire: truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, pos
        shift += 7
        if shift >= 70:
            raise ValueError("wire: varint longer than ten bytes")


def _to_varint(t: str, v: int) -> int:
    lo, hi = _RANGES[t]
    v = int(v)
    if not lo <= v <= hi:
        raise ValueError(f"wire: {v} out of range for {t}")
    if t == "sint64":
        return ((v << 1) ^ (v >> 63)) & _U64
    return v & _U64


def _from_varint(t: str, v: int) -> int:
    if t == "sint64":
        return (v >> 1) ^ -(v & 1)
    if t == "int64":
        v &= _U64
        return v - (1 << 64) if v >> 63 else v
    if t == "uint32":
        return v & 0xFFFFFFFF
    return v


def _is_default(t: str, v) -> bool:
    if t == "double":
        return v == 0.0 and math.copysign(1.0, v) > 0
    return v == _DEFAULT[t]


def _put_scalar(out: bytearray, t: str, v) -> None:
    if t == "double":
        out += _F64.pack(float(v))
    elif t in ("string", "bytes"):
        data = v.encode() if t == "string" else bytes(v)
        _put_varint(out, len(data))
        out += data
    else:
        _put_varint(out, _to_varint(t, v))


def _skip(buf, pos: int, wt: int) -> int:
    if wt == VARINT:
        return _get_varint(buf, pos)[1]
    if wt == I64:
        return pos + 8
    if wt == LEN:
        ln, pos = _get_varint(buf, pos)
        return pos + ln
    if wt == 5:  # fixed32
        return pos + 4
    raise ValueError(f"wire: unsupported wire type {wt}")


# --- messages -----------------------------------------------------------------


class Message:
    """A message of the schema: its fields are attributes (a repeated
    field a list, an absent sub-message None)."""

    FIELDS: tuple[Field, ...] = ()
    _BY_NAME: dict[str, Field] = {}
    _BY_NUMBER: dict[int, Field] = {}
    _ORDER: tuple[Field, ...] = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NAME = {f.name: f for f in cls.FIELDS}
        cls._BY_NUMBER = {f.number: f for f in cls.FIELDS}
        cls._ORDER = tuple(sorted(cls.FIELDS, key=lambda f: f.number))

    def __init__(self, **values):
        unknown = set(values) - set(self._BY_NAME)
        if unknown:
            raise ValueError(f"{type(self).__name__} has no field(s) {sorted(unknown)}")
        for f in self.FIELDS:
            v = values.get(f.name)
            if f.repeated:
                v = [] if v is None else list(v)
            elif v is None and not f.is_message:
                v = _DEFAULT[f.type]
            setattr(self, f.name, v)

    def HasField(self, name: str) -> bool:
        f = self._BY_NAME[name]
        if f.repeated or not f.is_message:
            raise ValueError(f"{type(self).__name__}.{name}: HasField takes a singular message field")
        return getattr(self, name) is not None

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and all(
            getattr(self, f.name) == getattr(other, f.name) for f in self.FIELDS)

    def __repr__(self) -> str:
        def show(v):
            return f"<{len(v)} bytes>" if isinstance(v, bytes) and len(v) > 16 else repr(v)
        body = ", ".join(f"{f.name}={show(getattr(self, f.name))}" for f in self.FIELDS)
        return f"{type(self).__name__}({body})"

    # --- writing ---------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._write(out)
        return bytes(out)

    def _write(self, out: bytearray) -> None:
        for f in self._ORDER:
            v = getattr(self, f.name)
            if f.is_message:
                for sub in (v if f.repeated else [] if v is None else [v]):
                    _put_varint(out, f.number << 3 | LEN)
                    body = sub.SerializeToString()
                    _put_varint(out, len(body))
                    out += body
            elif f.repeated and f.wire_type != LEN:
                if not v:
                    continue
                body = bytearray()
                if f.type == "double":
                    body += struct.pack(f"<{len(v)}d", *map(float, v))
                else:
                    for x in v:
                        _put_varint(body, _to_varint(f.type, x))
                _put_varint(out, f.number << 3 | LEN)
                _put_varint(out, len(body))
                out += body
            else:
                for x in (v if f.repeated else [] if _is_default(f.type, v) else [v]):
                    _put_varint(out, f.number << 3 | f.wire_type)
                    _put_scalar(out, f.type, x)

    # --- reading ---------------------------------------------------------
    @classmethod
    def FromString(cls, data) -> "Message":
        buf = memoryview(data).cast("B")
        return cls._read(buf, 0, len(buf))

    @classmethod
    def _read(cls, buf, pos: int, end: int) -> "Message":
        msg = cls()
        while pos < end:
            key, pos = _get_varint(buf, pos)
            num, wt = key >> 3, key & 7
            f = cls._BY_NUMBER.get(num)
            packed = f is not None and f.repeated and wt == LEN and f.wire_type != LEN
            if f is None or (wt != f.wire_type and not packed):
                pos = _skip(buf, pos, wt)
                continue
            if wt == LEN:
                ln, pos = _get_varint(buf, pos)
                stop = pos + ln
                if stop > end:
                    raise ValueError(f"wire: {cls.__name__}.{f.name} runs past its message")
                if packed:
                    getattr(msg, f.name).extend(_read_packed(f.type, buf, pos, stop))
                    v = None
                elif f.is_message:
                    v = f.type._read(buf, pos, stop)
                elif f.type == "string":
                    v = bytes(buf[pos:stop]).decode()
                else:
                    v = bytes(buf[pos:stop])
                pos = stop
            elif wt == I64:
                if pos + 8 > end:
                    raise ValueError(f"wire: {cls.__name__}.{f.name} runs past its message")
                v = _F64.unpack_from(buf, pos)[0]
                pos += 8
            else:
                raw, pos = _get_varint(buf, pos)
                v = _from_varint(f.type, raw)
            if packed:
                continue
            if f.repeated:
                getattr(msg, f.name).append(v)
            else:
                setattr(msg, f.name, v)
        if pos != end:
            raise ValueError(f"wire: {cls.__name__} runs past its end")
        return msg


def _read_packed(t: str, buf, pos: int, stop: int) -> list:
    if t == "double":
        if (stop - pos) % 8:
            raise ValueError("wire: packed doubles of a length not a multiple of 8")
        return list(struct.unpack_from(f"<{(stop - pos) // 8}d", buf, pos))
    out = []
    while pos < stop:
        raw, pos = _get_varint(buf, pos)
        out.append(_from_varint(t, raw))
    if pos != stop:
        raise ValueError("wire: packed varints run past their field")
    return out


# --- the schema (lol.proto) ---------------------------------------------------


class Rq(Message):
    """A ring element mod q: RNS residues, little-endian u32, (nrns, n)."""

    FIELDS = (Field("m", 1, "uint64"), Field("qs", 2, "uint64", True),
              Field("rep", 3, "string"), Field("coeffs", 4, "bytes"))


class R(Message):
    """An integer ring element: centered coefficients."""

    FIELDS = (Field("m", 1, "uint64"), Field("rep", 3, "string"),
              Field("coeffs", 2, "sint64", True))


class Kq(Message):
    """A continuous torus element (decoding coordinates, float64)."""

    FIELDS = (Field("m", 1, "uint64"), Field("q", 2, "double"),
              Field("coeffs", 3, "double", True))


class LinearRq(Message):
    FIELDS = (Field("e", 1, "uint64"), Field("r", 2, "uint64"), Field("s", 3, "uint64"),
              Field("ys", 4, Rq, True))


class SecretKey(Message):
    FIELDS = (Field("m", 1, "uint64"), Field("p", 2, "uint64"), Field("qs", 3, "uint64", True),
              Field("var", 4, "double"), Field("s", 5, R))


class SHECiphertext(Message):
    FIELDS = (Field("m", 1, "uint64"), Field("qs", 2, "uint64", True), Field("p", 3, "uint64"),
              Field("f", 4, "uint64"), Field("cs", 5, Rq, True), Field("encoding", 6, "string"))


class KSHint(Message):
    FIELDS = (Field("m", 1, "uint64"), Field("qs", 2, "uint64", True), Field("p", 3, "uint64"),
              Field("var", 4, "double"), Field("gad", 5, "string"),
              Field("h0", 6, Rq, True), Field("h1", 7, Rq, True))


class KSHintExt(Message):
    FIELDS = (Field("m", 1, "uint64"), Field("qs", 2, "uint64", True),
              Field("special_qs", 3, "uint64", True), Field("p", 4, "uint64"),
              Field("var", 5, "double"), Field("gad", 6, "string"),
              Field("h0", 7, Rq, True), Field("h1", 8, Rq, True))


class TunnelHint(Message):
    FIELDS = (Field("lin", 1, LinearRq), Field("gad", 2, "string"),
              Field("hints", 3, KSHint, True))


class PTRoundHints(Message):
    FIELDS = (Field("hints", 1, KSHint, True),)


class EvalHints(Message):
    FIELDS = (Field("tunnels", 1, TunnelHint, True), Field("p_final", 2, "uint64"),
              Field("rounds", 3, PTRoundHints))


class Challenge(Message):
    FIELDS = (Field("challenge_id", 1, "uint32"), Field("m", 2, "uint64"),
              Field("q", 3, "uint64"), Field("svar", 4, "double"),
              Field("num_instances", 5, "uint32"), Field("kind", 6, "string"),
              Field("qprime", 7, "uint64"), Field("beacon_epoch", 8, "int64"),
              Field("beacon_offset", 9, "uint32"))


class InstanceDisc(Message):
    FIELDS = (Field("challenge_id", 1, "uint32"), Field("instance_id", 2, "uint32"),
              Field("a", 3, Rq), Field("b", 4, Rq), Field("bound", 5, "uint64"))


class InstanceCont(Message):
    FIELDS = (Field("challenge_id", 1, "uint32"), Field("instance_id", 2, "uint32"),
              Field("a", 3, Rq), Field("b", 4, Kq), Field("bound", 5, "double"))


class InstanceRLWR(Message):
    FIELDS = (Field("challenge_id", 1, "uint32"), Field("instance_id", 2, "uint32"),
              Field("a", 3, Rq), Field("b", 4, Rq))


class Secret(Message):
    FIELDS = (Field("challenge_id", 1, "uint32"), Field("instance_id", 2, "uint32"),
              Field("m", 3, "uint64"), Field("s", 4, R))


MESSAGES = (Rq, R, Kq, LinearRq, SecretKey, SHECiphertext, KSHint, KSHintExt, TunnelHint,
            PTRoundHints, EvalHints, Challenge, InstanceDisc, InstanceCont, InstanceRLWR, Secret)
