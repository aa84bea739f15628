"""Randomness beacon interface (reference: NIST beacon client in
`rlwe-challenges .../Beacon.hs`); the port's own copy of
`lol_tpu/challenges/beacon.py`, which is pure Python.

`Beacon.bits(epoch, offset, nbits)` returns the selection bits for a
challenge.  `LocalBeacon` is the offline-deterministic stand-in (SHA-512
of the epoch number); a NIST-beacon-backed implementation plugs in by
implementing `record(epoch)`.
"""

from __future__ import annotations

import hashlib


class Beacon:
    def record(self, epoch: int) -> bytes:
        """The 64-byte beacon output for an epoch."""
        raise NotImplementedError

    def bits(self, epoch: int, offset: int, nbits: int) -> int:
        """nbits of the record starting at bit `offset` as an int."""
        rec = self.record(epoch)
        as_int = int.from_bytes(rec, "big")
        total = len(rec) * 8
        if offset + nbits > total:
            raise ValueError("beacon: offset+nbits beyond record")
        return (as_int >> (total - offset - nbits)) & ((1 << nbits) - 1)


class LocalBeacon(Beacon):
    """Deterministic offline beacon: SHA-512(epoch as decimal string)."""

    def record(self, epoch: int) -> bytes:
        return hashlib.sha512(str(int(epoch)).encode()).digest()


class NistRecordBeacon(Beacon):
    """NIST randomness-beacon records loaded from disk (offline client).

    The reference's `Beacon.hs` fetches records from the NIST beacon over
    HTTP at challenge-suppression time; this offline client reads
    pre-fetched record files from a directory
    — one file per epoch, named `<epoch>.xml` (beacon v1) or
    `<epoch>.json` (beacon v2.0) — and extracts the 512-bit output value.

    Integrity checking mirrors what can be done without the NIST X.509
    certificate: for v1 records the published invariant
    `outputValue == SHA-512(signatureValue)` is verified when the
    signature field is present (RSA signature validation itself needs the
    cert and the wire-format serialization, out of scope offline); for
    v2 records the `outputValue` length/hex shape is checked.
    """

    def __init__(self, record_dir, verify_chain: bool = True):
        from pathlib import Path

        self.record_dir = Path(record_dir)
        self.verify_chain = verify_chain

    @staticmethod
    def _parse_v1_xml(text: str) -> dict:
        import xml.etree.ElementTree as ET

        root = ET.fromstring(text)

        def field(name: str) -> str | None:
            # tolerate namespaced and plain tags
            for el in root.iter():
                if el.tag.split("}")[-1] == name:
                    return (el.text or "").strip()
            return None

        return {
            "timeStamp": field("timeStamp"),
            "outputValue": field("outputValue"),
            "signatureValue": field("signatureValue"),
        }

    @staticmethod
    def _parse_v2_json(text: str) -> dict:
        import json

        doc = json.loads(text)
        pulse = doc.get("pulse", doc)
        return {
            "timeStamp": str(pulse.get("timeStamp", "")),
            "outputValue": pulse.get("outputValue", ""),
            "signatureValue": pulse.get("signatureValue", ""),
        }

    def record(self, epoch: int) -> bytes:
        xml_path = self.record_dir / f"{int(epoch)}.xml"
        json_path = self.record_dir / f"{int(epoch)}.json"
        if xml_path.exists():
            rec = self._parse_v1_xml(xml_path.read_text())
            out_hex = rec["outputValue"]
            if not out_hex or len(out_hex) != 128:
                raise ValueError(f"beacon record {xml_path}: bad outputValue")
            if self.verify_chain and rec.get("signatureValue"):
                sig = bytes.fromhex(rec["signatureValue"])
                want = hashlib.sha512(sig).hexdigest().upper()
                if out_hex.upper() != want:
                    raise ValueError(
                        f"beacon record {xml_path}: outputValue != "
                        "SHA-512(signatureValue) — record corrupt or forged"
                    )
            return bytes.fromhex(out_hex)
        if json_path.exists():
            rec = self._parse_v2_json(json_path.read_text())
            out_hex = rec["outputValue"]
            if not out_hex or len(out_hex) != 128:
                raise ValueError(f"beacon record {json_path}: bad outputValue")
            return bytes.fromhex(out_hex)
        raise FileNotFoundError(
            f"no beacon record for epoch {epoch} under {self.record_dir} "
            f"(expected {xml_path.name} or {json_path.name})"
        )
