"""Avro container-file reader/writer, pure Python, no external codec
(the port's copy of `spark_tpu/io/avro.py`).

Role of the reference's Avro connector (connector/avro/ —
AvroFileFormat, AvroSerializer/Deserializer). Scope: the Avro 1.x
object-container format with null or deflate codec, record schemas of
primitive fields (null/boolean/int/long/float/double/string/bytes) and
their nullable unions — the shape Spark writes for flat DataFrames.
Arrow tables in, Arrow tables out; the columnar engine never sees the
row-oriented wire format.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

import pyarrow as pa

_MAGIC = b"Obj\x01"


# -- binary primitives (Avro spec: zigzag varints) --------------------------

def _zigzag_encode(n: int) -> bytes:
    z = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_decode(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated avro varint")
        v = b[0]
        acc |= (v & 0x7F) << shift
        if not v & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_bytes(out: bytearray, b: bytes) -> None:
    out += _zigzag_encode(len(b))
    out += b


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _zigzag_decode(buf)
    return buf.read(n)


# -- schema mapping ---------------------------------------------------------

_ARROW_TO_AVRO = [
    (pa.types.is_boolean, "boolean"),
    (pa.types.is_int32, "int"),
    (pa.types.is_integer, "long"),
    (pa.types.is_float32, "float"),
    (pa.types.is_floating, "double"),
    (pa.types.is_binary, "bytes"),
    (pa.types.is_string, "string"),
    (pa.types.is_large_string, "string"),
    (pa.types.is_date32, "int"),
    (pa.types.is_timestamp, "long"),
]

_AVRO_TO_ARROW = {
    "boolean": pa.bool_(), "int": pa.int32(), "long": pa.int64(),
    "float": pa.float32(), "double": pa.float64(),
    "string": pa.string(), "bytes": pa.binary(), "null": pa.null(),
}


def _avro_type(t: pa.DataType):
    """Avro schema for one arrow type — a string primitive or a
    logical-typed dict (date / timestamp-micros, like the reference's
    AvroSerializer)."""
    if pa.types.is_date32(t):
        return {"type": "int", "logicalType": "date"}
    if pa.types.is_timestamp(t):
        return {"type": "long", "logicalType": "timestamp-micros"}
    for pred, name in _ARROW_TO_AVRO:
        if pred(t):
            return name
    raise ValueError(f"avro writer: unsupported arrow type {t}")


def _schema_json(schema: pa.Schema) -> str:
    fields = []
    for f in schema:
        at = _avro_type(f.type)
        fields.append({"name": f.name,
                       "type": ["null", at] if f.nullable else at})
    return json.dumps({"type": "record", "name": "topLevelRecord",
                       "fields": fields})


class _FieldSpec:
    __slots__ = ("name", "prim", "logical", "null_branch")

    def __init__(self, name, prim, logical, null_branch):
        self.name = name
        self.prim = prim            # avro primitive the bytes encode
        self.logical = logical      # None | 'date' | 'timestamp-micros'
        self.null_branch = null_branch  # union index of "null", or None

    @property
    def arrow_type(self):
        if self.logical == "date":
            return pa.date32()
        if self.logical == "timestamp-micros":
            return pa.timestamp("us")
        return _AVRO_TO_ARROW[self.prim]


def _one_type(t):
    """(primitive, logical) from a string or logical-typed dict."""
    if isinstance(t, dict):
        return t["type"], t.get("logicalType")
    return t, None


def _field_types(schema_json: str) -> list[_FieldSpec]:
    sch = json.loads(schema_json)
    if sch.get("type") != "record":
        raise ValueError("only record-typed avro files are supported")
    out = []
    for f in sch["fields"]:
        t = f["type"]
        null_branch = None
        if isinstance(t, list):     # union — support null + one type,
            # in EITHER order (the spec encodes the union INDEX)
            non_null = [(i, x) for i, x in enumerate(t) if x != "null"]
            nulls = [i for i, x in enumerate(t) if x == "null"]
            if len(non_null) != 1 or len(t) > 2:
                raise ValueError(f"unsupported avro union {t}")
            null_branch = nulls[0] if nulls else None
            t = non_null[0][1]
        prim, logical = _one_type(t)
        if prim not in _AVRO_TO_ARROW:
            raise ValueError(f"unsupported avro type {prim!r}")
        out.append(_FieldSpec(f["name"], prim, logical, null_branch))
    return out


# -- value codecs -----------------------------------------------------------

def _encode_value(out: bytearray, t: str, v) -> None:
    if t == "boolean":
        out.append(1 if v else 0)
    elif t in ("int", "long"):
        out += _zigzag_encode(int(v))
    elif t == "float":
        out += struct.pack("<f", float(v))
    elif t == "double":
        out += struct.pack("<d", float(v))
    elif t == "string":
        _write_bytes(out, str(v).encode("utf-8"))
    elif t == "bytes":
        _write_bytes(out, bytes(v))
    else:
        raise ValueError(t)


def _decode_value(buf: io.BytesIO, t: str):
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return _zigzag_decode(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "string":
        return _read_bytes(buf).decode("utf-8")
    if t == "bytes":
        return _read_bytes(buf)
    raise ValueError(t)


# -- container file ---------------------------------------------------------

def write_avro(path: str, table: pa.Table, codec: str = "deflate",
               block_rows: int = 4096) -> None:
    sync = os.urandom(16)
    schema_json = _schema_json(table.schema)
    fts = _field_types(schema_json)
    # logical types encode as their integer representation
    cols = []
    for i, f in enumerate(table.schema):
        col = table.column(i)
        if pa.types.is_date32(f.type):
            col = col.cast(pa.int32())
        elif pa.types.is_timestamp(f.type):
            col = col.cast(pa.timestamp("us")).cast(pa.int64())
        cols.append(col.to_pylist())
    with open(path, "wb") as f:
        f.write(_MAGIC)
        meta = bytearray()
        meta += _zigzag_encode(2)
        _write_bytes(meta, b"avro.schema")
        _write_bytes(meta, schema_json.encode())
        _write_bytes(meta, b"avro.codec")
        _write_bytes(meta, codec.encode())
        meta += _zigzag_encode(0)
        f.write(bytes(meta))
        f.write(sync)
        n = table.num_rows
        for lo in range(0, max(n, 1), block_rows):
            hi = min(lo + block_rows, n)
            if hi <= lo:
                break
            body = bytearray()
            for i in range(lo, hi):
                for ft, col in zip(fts, cols):
                    v = col[i]
                    if ft.null_branch is not None:
                        if v is None:
                            body += _zigzag_encode(ft.null_branch)
                            continue
                        body += _zigzag_encode(1 - ft.null_branch)
                    _encode_value(body, ft.prim, v)
            raw = bytes(body)
            if codec == "deflate":
                raw = zlib.compress(raw)[2:-4]  # avro: raw deflate stream
            block = bytearray()
            block += _zigzag_encode(hi - lo)
            block += _zigzag_encode(len(raw))
            block += raw
            f.write(bytes(block))
            f.write(sync)


def read_avro(path: str) -> pa.Table:
    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    if buf.read(4) != _MAGIC:
        raise ValueError(f"{path}: not an avro object container file")
    meta: dict[str, bytes] = {}
    while True:
        count = _zigzag_decode(buf)
        if count == 0:
            break
        if count < 0:
            # spec: negative block count = |count| entries preceded by
            # the block's byte size (which we can skip past the read)
            _zigzag_decode(buf)
            count = -count
        for _ in range(count):
            k = _read_bytes(buf).decode()
            meta[k] = _read_bytes(buf)
    codec = meta.get("avro.codec", b"null").decode()
    fts = _field_types(meta["avro.schema"].decode())
    sync = buf.read(16)
    cols: dict[str, list] = {ft.name: [] for ft in fts}
    while True:
        head = buf.read(1)
        if not head:
            break
        buf.seek(-1, io.SEEK_CUR)
        nrec = _zigzag_decode(buf)
        blen = _zigzag_decode(buf)
        raw = buf.read(blen)
        if codec == "deflate":
            raw = zlib.decompress(raw, wbits=-15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        if buf.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt)")
        body = io.BytesIO(raw)
        for _ in range(nrec):
            for ft in fts:
                if ft.null_branch is not None:
                    branch = _zigzag_decode(body)
                    if branch == ft.null_branch:
                        cols[ft.name].append(None)
                        continue
                cols[ft.name].append(_decode_value(body, ft.prim))
    arrays = {}
    for ft in fts:
        arr = pa.array(cols[ft.name], _AVRO_TO_ARROW[ft.prim])
        if ft.logical is not None:
            arr = arr.cast(ft.arrow_type)
        arrays[ft.name] = arr
    return pa.table(arrays)
