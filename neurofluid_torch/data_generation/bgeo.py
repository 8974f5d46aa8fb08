"""Classic BGEO particle file I/O in pure Python (partio replacement; a
copy of neurofluid_tpu/data_generation/bgeo.py).

The reference reads/writes SPlisHSPlasH's .bgeo outputs through the partio
C++ library (reference data_generation/physics_data_helper.py:28-81). This
module implements the classic (pre-Houdini-12) big-endian BGEO layout that
partio and SPlisHSPlasH emit: enough to round-trip particle positions and
arbitrary float/int point attributes (velocity, id, ...).

Layout (big-endian throughout):
  magic 'Bgeo' | 'V' | version int32 | nPoints nPrims nPointGroups
  nPrimGroups nPointAttrib nVertexAttrib nPrimAttrib nAttrib (int32 each)
  per point attribute: name (uint16 len + bytes), size uint16, type int32
    (0=float, 1=int, 5=indexed string — unsupported), default (size x int32/float32)
  point data: nPoints x (4 float32 homogeneous position + attribute payload)
  trailer: two uint8s (0x00, 0xff) after optional prim data (we write none).

Files with primitives sections are readable as long as the point block comes
first (always true for particle files).
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = b"Bgeo"
ATTR_FLOAT = 0
ATTR_INT = 1


def write_bgeo(path: str, positions: np.ndarray, attributes: dict | None = None,
               version: int = 5) -> None:
    """Write particle positions (+ named per-point attributes) as classic bgeo.

    attributes: {name: (N,) or (N, C) float32/int32 arrays}.
    """
    positions = np.asarray(positions, np.float32)
    n = positions.shape[0]
    attributes = attributes or {}

    attr_meta = []
    for name, arr in attributes.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        assert arr.shape[0] == n, f"attribute {name} length mismatch"
        kind = ATTR_INT if np.issubdtype(arr.dtype, np.integer) else ATTR_FLOAT
        dtype = np.int32 if kind == ATTR_INT else np.float32
        attr_meta.append((name, arr.astype(dtype), kind))

    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(b"V")
        f.write(struct.pack(">i", version))
        f.write(struct.pack(">8i", n, 0, 0, 0, len(attr_meta), 0, 0, 0))
        for name, arr, kind in attr_meta:
            nb = name.encode()
            f.write(struct.pack(">H", len(nb)))
            f.write(nb)
            f.write(struct.pack(">H", arr.shape[1]))
            f.write(struct.pack(">i", kind))
            fmt = ">%d%s" % (arr.shape[1], "i" if kind == ATTR_INT else "f")
            f.write(struct.pack(fmt, *([0] * arr.shape[1])))
        # interleaved point records: x y z w + attributes
        row_parts = [np.concatenate(
            [positions, np.ones((n, 1), np.float32)], axis=1
        ).astype(">f4")]
        for _name, arr, kind in attr_meta:
            row_parts.append(arr.astype(">i4" if kind == ATTR_INT else ">f4"))
        widths = [p.shape[1] for p in row_parts]
        record = np.empty((n, sum(widths) * 4), np.uint8)
        col = 0
        for p in row_parts:
            raw = p.tobytes()
            view = np.frombuffer(raw, np.uint8).reshape(n, p.shape[1] * 4)
            record[:, col : col + view.shape[1]] = view
            col += view.shape[1]
        f.write(record.tobytes())
        f.write(struct.pack(">BB", 0x00, 0xFF))


def read_bgeo(path: str):
    """Read a classic bgeo particle file -> (positions (N, 3), attributes dict)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path}: not a classic Bgeo file (magic {data[:4]!r})")
    off = 4
    if data[off : off + 1] == b"V":
        off += 1
        (version,) = struct.unpack_from(">i", data, off)
        off += 4
    (n, _nprims, _npg, _nprimg, n_attr, _nva, _npa, _nda) = struct.unpack_from(
        ">8i", data, off
    )
    off += 32

    attrs = []
    for _ in range(n_attr):
        (name_len,) = struct.unpack_from(">H", data, off)
        off += 2
        name = data[off : off + name_len].decode()
        off += name_len
        (size,) = struct.unpack_from(">H", data, off)
        off += 2
        (kind,) = struct.unpack_from(">i", data, off)
        off += 4
        if kind not in (ATTR_FLOAT, ATTR_INT):
            raise NotImplementedError(
                f"{path}: attribute {name} type {kind} not supported"
            )
        off += 4 * size  # defaults
        attrs.append((name, size, kind))

    row_width = 4 + sum(size for _, size, _ in attrs)
    raw = np.frombuffer(data, dtype=">f4", count=n * row_width, offset=off)
    table = raw.reshape(n, row_width)
    positions = np.ascontiguousarray(table[:, :3]).astype(np.float32)
    out = {}
    col = 4
    for name, size, kind in attrs:
        block = table[:, col : col + size]
        if kind == ATTR_INT:
            block = np.ascontiguousarray(block).view(">i4").astype(np.int32)
        else:
            block = np.ascontiguousarray(block).astype(np.float32)
        out[name] = block[:, 0] if size == 1 else block
        col += size
    return positions, out
