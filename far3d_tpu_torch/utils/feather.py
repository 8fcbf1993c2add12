"""A small Feather V2 writer: an uncompressed Arrow IPC file of int64,
float64 and utf8 columns, one record batch, no nulls.

The AV2 submission is a Feather file (``DataFrame.to_feather`` in the JAX
package). The machine with the card has neither pandas nor pyarrow, so the
port writes the format itself: the Arrow IPC file layout (``ARROW1``, the
schema message, one record batch message, the footer) with its FlatBuffers
metadata built by hand, following the Arrow format's Schema.fbs,
Message.fbs and File.fbs. ``num_rows`` reads the row count back from the
file's footer.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

MAGIC = b'ARROW1'
CONTINUATION = 0xFFFFFFFF
V5 = 4                                    # MetadataVersion.V5
_SCHEMA, _RECORD_BATCH = 1, 3             # MessageHeader union tags
_INT, _FLOAT, _UTF8 = 2, 3, 5             # Type union tags
_DOUBLE = 2                               # Precision.DOUBLE


# ---------------------------------------------------------------------------
# a forward FlatBuffers encoder: each object is written after whatever
# refers to it, so every offset (unsigned) points forward
# ---------------------------------------------------------------------------

class Table:
    """A FlatBuffers table: {slot: (scalar format, value)} or {slot: child}
    where a child is a Table, a str, a list of Tables or a StructVector."""

    def __init__(self, fields: Dict[int, object]):
        self.fields = fields


class StructVector:
    """A vector of fixed-size structs, already packed, aligned to 8."""

    def __init__(self, packed: bytes, count: int):
        self.packed, self.count = packed, count


def _pad_to(buf: bytearray, align: int, extra: int = 0) -> None:
    """Pad so that len(buf) + extra is a multiple of align."""
    buf.extend(b'\0' * (-(len(buf) + extra) % align))


def _place(buf: bytearray, obj) -> int:
    """Append `obj` to `buf`; returns the position an offset must reach."""
    if isinstance(obj, str):
        data = obj.encode()
        _pad_to(buf, 4)
        pos = len(buf)
        buf.extend(struct.pack('<I', len(data)) + data + b'\0')
        return pos
    if isinstance(obj, StructVector):
        _pad_to(buf, 8, 4)
        pos = len(buf)
        buf.extend(struct.pack('<I', obj.count) + obj.packed)
        return pos
    if isinstance(obj, list):
        _pad_to(buf, 4)
        pos = len(buf)
        buf.extend(struct.pack('<I', len(obj)) + b'\0' * (4 * len(obj)))
        for i, child in enumerate(obj):
            slot = pos + 4 + 4 * i
            struct.pack_into('<I', buf, slot, _place(buf, child) - slot)
        return pos
    # a table: its vtable first, then the table, then its children
    fields = obj.fields
    nslots = max(fields, default=-1) + 1
    scalars = {k: v for k, v in fields.items() if isinstance(v, tuple)}
    children = {k: v for k, v in fields.items() if not isinstance(v, tuple)}
    layout, size = {}, 4                       # after the soffset
    items = [(k, struct.calcsize('<' + f)) for k, (f, _) in scalars.items()]
    items += [(k, 4) for k in children]
    for k, width in sorted(items, key=lambda kw: -kw[1]):
        size += -size % width
        layout[k] = size
        size += width
    size += -size % 4
    _pad_to(buf, 2)
    vt_pos = len(buf)
    buf.extend(struct.pack(f'<HH{nslots}H', 4 + 2 * nslots, size,
                           *[layout.get(k, 0) for k in range(nslots)]))
    _pad_to(buf, 8)
    pos = len(buf)
    buf.extend(b'\0' * size)
    struct.pack_into('<i', buf, pos, pos - vt_pos)
    for k, (fmt, value) in scalars.items():
        struct.pack_into('<' + fmt, buf, pos + layout[k], value)
    for k, child in children.items():
        slot = pos + layout[k]
        struct.pack_into('<I', buf, slot, _place(buf, child) - slot)
    return pos


def encode(root: Table) -> bytes:
    """The FlatBuffers bytes of `root`, padded to a multiple of 8."""
    buf = bytearray(4)
    struct.pack_into('<I', buf, 0, _place(buf, root))
    _pad_to(buf, 8)
    return bytes(buf)


def _read_table(buf: bytes, pos: int):
    """-> field(slot, fmt) reading a scalar, or a child's position for
    fmt None (None where the slot is absent)."""
    vt = pos - struct.unpack_from('<i', buf, pos)[0]
    vt_size = struct.unpack_from('<H', buf, vt)[0]

    def field(slot, fmt):
        at = 4 + 2 * slot
        off = struct.unpack_from('<H', buf, vt + at)[0] if at < vt_size else 0
        if not off:
            return None
        if fmt is None:
            return pos + off + struct.unpack_from('<I', buf, pos + off)[0]
        return struct.unpack_from('<' + fmt, buf, pos + off)[0]
    return field


# ---------------------------------------------------------------------------
# Arrow IPC
# ---------------------------------------------------------------------------

def _field(name: str, kind: str) -> Table:
    if kind == 'int64':
        type_tag, type_table = _INT, Table({0: ('i', 64), 1: ('?', True)})
    elif kind == 'float64':
        type_tag, type_table = _FLOAT, Table({0: ('h', _DOUBLE)})
    else:
        type_tag, type_table = _UTF8, Table({})
    # name, nullable, type_type, type, children
    return Table({0: name, 1: ('?', True), 2: ('B', type_tag), 3: type_table,
                  5: []})


def _schema(columns: Sequence[Tuple[str, str]]) -> Table:
    # endianness Little (0), fields
    return Table({0: ('h', 0), 1: [_field(n, k) for n, k in columns]})


def _message(header_tag: int, header: Table, body_len: int) -> bytes:
    meta = encode(Table({0: ('h', V5), 1: ('B', header_tag), 2: header,
                         3: ('q', body_len)}))
    return struct.pack('<Ii', CONTINUATION, len(meta)) + meta


def _kind(values: np.ndarray) -> str:
    if values.dtype.kind in 'iu':
        return 'int64'
    if values.dtype.kind == 'f':
        return 'float64'
    if values.dtype.kind in 'OU':
        return 'utf8'
    raise TypeError(f'feather: no column type for {values.dtype}')


def write_feather(path: str, columns: Dict[str, np.ndarray]) -> int:
    """Write `columns` ({name: 1-d array}, all of one length; integers as
    int64, floats as float64, strings as utf8) as a Feather V2 file; returns
    the row count."""
    names = list(columns)
    arrays = [np.asarray(columns[n]) for n in names]
    lengths = {len(a) for a in arrays}
    if len(lengths) > 1:
        raise ValueError(f'feather: columns of lengths {sorted(lengths)}')
    rows = lengths.pop() if lengths else 0
    kinds = [_kind(a) for a in arrays]

    body = bytearray()
    nodes: List[Tuple[int, int]] = []
    buffers: List[Tuple[int, int]] = []

    def add_buffer(data: bytes) -> None:
        buffers.append((len(body), len(data)))
        body.extend(data)
        _pad_to(body, 8)

    for a, kind in zip(arrays, kinds):
        nodes.append((rows, 0))
        add_buffer(b'')                                  # no validity bitmap
        if kind == 'utf8':
            data = [str(s).encode() for s in a]
            offsets = np.zeros(rows + 1, np.int32)
            offsets[1:] = np.cumsum([len(d) for d in data])
            add_buffer(offsets.astype('<i4').tobytes())
            add_buffer(b''.join(data))
        else:
            add_buffer(a.astype('<i8' if kind == 'int64' else '<f8')
                       .tobytes())

    schema = _schema(list(zip(names, kinds)))
    batch = Table({0: ('q', rows),
                   1: StructVector(b''.join(struct.pack('<qq', *n)
                                            for n in nodes), len(nodes)),
                   2: StructVector(b''.join(struct.pack('<qq', *b)
                                            for b in buffers), len(buffers))})
    out = bytearray(MAGIC + b'\0\0')
    out += _message(_SCHEMA, schema, 0)
    batch_at = len(out)
    batch_msg = _message(_RECORD_BATCH, batch, len(body))
    out += batch_msg + body
    out += struct.pack('<Ii', CONTINUATION, 0)           # end of stream
    block = struct.pack('<qi4xq', batch_at, len(batch_msg), len(body))
    footer = encode(Table({0: ('h', V5), 1: schema, 2: StructVector(b'', 0),
                           3: StructVector(block, 1)}))
    out += footer + struct.pack('<i', len(footer)) + MAGIC
    with open(path, 'wb') as f:
        f.write(out)
    return rows


def num_rows(path: str) -> int:
    """The row count of an Arrow IPC file, from its footer: the sum of the
    lengths of the record batches the footer lists."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:6] != MAGIC or data[-6:] != MAGIC:
        raise ValueError(f'{path} is not an Arrow IPC file')
    footer_len = struct.unpack_from('<i', data, len(data) - 10)[0]
    footer = data[len(data) - 10 - footer_len:len(data) - 10]
    batches = _read_table(footer, struct.unpack_from('<I', footer, 0)[0])(
        3, None)
    total = 0
    for i in range(struct.unpack_from('<I', footer, batches)[0]):
        offset, meta_len, _ = struct.unpack_from('<qi4xq', footer,
                                                 batches + 4 + 24 * i)
        meta = data[offset + 8:offset + meta_len]
        message = _read_table(meta, struct.unpack_from('<I', meta, 0)[0])
        if message(1, 'B') != _RECORD_BATCH:
            raise ValueError(f'{path}: block {i} is not a record batch')
        total += _read_table(meta, message(2, None))(0, 'q')
    return total
