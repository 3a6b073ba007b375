"""VARIANT: binary semi-structured values (the port's copy of
`spark_tpu/utils/variant.py`; it needs the standard library alone).

Role of the reference's common/variant (Variant.java:43,
VariantBuilder/VariantUtil — the open binary encoding for
semi-structured data shared with Delta/Iceberg): a value encodes as two
byte strings, `metadata` (a sorted field-name dictionary, so repeated
keys across a column compress and field lookup is a binary search) and
`value` (a tagged tree). This implementation keeps the same
metadata/value split and dictionary-sorted field ids; the byte-level
tags are this engine's own (documented below) since only our
encoder/decoder touches them.

Value encoding (1 tag byte + payload, little-endian):
  0x00 null            0x01 true        0x02 false
  0x03 int64 (8B)      0x04 float64 (8B)
  0x05 string: u32 len + utf-8
  0x06 array:  u32 count + count * (u32 size + value)
  0x07 object: u32 count + count * (u32 field_id + u32 size + value)
  0x08 decimal: u8 scale + u32 len + unscaled int (signed, LE)
"""

from __future__ import annotations

import json
import struct
from decimal import Decimal
from typing import Any


def _collect_keys(v: Any, keys: set) -> None:
    if isinstance(v, dict):
        for k, sub in v.items():
            keys.add(k)
            _collect_keys(sub, keys)
    elif isinstance(v, (list, tuple)):
        for sub in v:
            _collect_keys(sub, keys)


def _encode_value(v: Any, key_ids: dict) -> bytes:
    if v is None:
        return b"\x00"
    if v is True:
        return b"\x01"
    if v is False:
        return b"\x02"
    if isinstance(v, int):
        return b"\x03" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x04" + struct.pack("<d", v)
    if isinstance(v, str):
        raw = v.encode()
        return b"\x05" + struct.pack("<I", len(raw)) + raw
    if isinstance(v, (list, tuple)):
        parts = [_encode_value(x, key_ids) for x in v]
        out = b"\x06" + struct.pack("<I", len(parts))
        for p in parts:
            out += struct.pack("<I", len(p)) + p
        return out
    if isinstance(v, dict):
        items = sorted(v.items(), key=lambda kv: key_ids[kv[0]])
        out = b"\x07" + struct.pack("<I", len(items))
        for k, sub in items:
            p = _encode_value(sub, key_ids)
            out += struct.pack("<II", key_ids[k], len(p)) + p
        return out
    if isinstance(v, Decimal):
        sign, digits, exponent = v.as_tuple()
        scale = -exponent if exponent < 0 else 0
        unscaled = int(v.scaleb(scale))
        raw = unscaled.to_bytes((unscaled.bit_length() + 8) // 8,
                                "little", signed=True)
        return b"\x08" + struct.pack("<BI", scale, len(raw)) + raw
    raise TypeError(f"cannot encode {type(v).__name__} as variant")


class Variant:
    """One encoded value: (metadata, value) byte strings."""

    __slots__ = ("metadata", "value")

    def __init__(self, metadata: bytes, value: bytes):
        self.metadata = metadata
        self.value = value

    # -- construction ----------------------------------------------------
    @staticmethod
    def of(obj: Any) -> "Variant":
        keys: set = set()
        _collect_keys(obj, keys)
        ordered = sorted(keys)
        key_ids = {k: i for i, k in enumerate(ordered)}
        meta = struct.pack("<I", len(ordered))
        for k in ordered:
            raw = k.encode()
            meta += struct.pack("<I", len(raw)) + raw
        return Variant(meta, _encode_value(obj, key_ids))

    @staticmethod
    def parse_json(text: str) -> "Variant":
        return Variant.of(json.loads(text, parse_float=float))

    # -- decoding --------------------------------------------------------
    def _keys(self) -> list[str]:
        n, = struct.unpack_from("<I", self.metadata, 0)
        off = 4
        out = []
        for _ in range(n):
            ln, = struct.unpack_from("<I", self.metadata, off)
            off += 4
            out.append(self.metadata[off:off + ln].decode())
            off += ln
        return out

    def to_python(self) -> Any:
        keys = self._keys()

        def dec(buf: bytes) -> Any:
            tag = buf[0]
            if tag == 0x00:
                return None
            if tag == 0x01:
                return True
            if tag == 0x02:
                return False
            if tag == 0x03:
                return struct.unpack_from("<q", buf, 1)[0]
            if tag == 0x04:
                return struct.unpack_from("<d", buf, 1)[0]
            if tag == 0x05:
                ln, = struct.unpack_from("<I", buf, 1)
                return buf[5:5 + ln].decode()
            if tag == 0x06:
                n, = struct.unpack_from("<I", buf, 1)
                off = 5
                out = []
                for _ in range(n):
                    ln, = struct.unpack_from("<I", buf, off)
                    off += 4
                    out.append(dec(buf[off:off + ln]))
                    off += ln
                return out
            if tag == 0x07:
                n, = struct.unpack_from("<I", buf, 1)
                off = 5
                out = {}
                for _ in range(n):
                    kid, ln = struct.unpack_from("<II", buf, off)
                    off += 8
                    out[keys[kid]] = dec(buf[off:off + ln])
                    off += ln
                return out
            if tag == 0x08:
                scale, ln = struct.unpack_from("<BI", buf, 1)
                unscaled = int.from_bytes(buf[6:6 + ln], "little",
                                          signed=True)
                return Decimal(unscaled).scaleb(-scale)
            raise ValueError(f"bad variant tag {tag:#x}")

        return dec(self.value)

    def to_json(self) -> str:
        return json.dumps(self.to_python(), default=str)

    # -- path access (variant_get role) ----------------------------------
    def get(self, path: str) -> Any:
        """`$.a.b[2]`-style extraction (VariantGet expression role)."""
        cur = self.to_python()
        if path.startswith("$"):
            path = path[1:]
        import re

        for part in re.findall(r"\.([A-Za-z_][\w]*)|\[(\d+)\]", path):
            name, idx = part
            if name:
                if not isinstance(cur, dict) or name not in cur:
                    return None
                cur = cur[name]
            else:
                i = int(idx)
                if not isinstance(cur, list) or i >= len(cur):
                    return None
                cur = cur[i]
        return cur

    def __eq__(self, other):
        return isinstance(other, Variant) and \
            self.to_python() == other.to_python()

    def __repr__(self):
        return f"Variant({self.to_json()})"
