"""Device memory accounting (the port's copy of the part of
`spark_tpu/exec/memory.py` the compile-tier chooser reads): bytes per row
of a schema."""

from __future__ import annotations

from ..types import dict_encoded


def schema_row_bytes(schema) -> int:
    """Device bytes per row: column data (dict-encoded = int32 codes) +
    validity planes + the row mask."""
    total = 1  # row mask
    for f in schema.fields:
        if dict_encoded(f.dataType):
            total += 4
        else:
            total += f.dataType.device_dtype.itemsize
        total += 1  # validity (may be absent; budget conservatively)
    return total
