"""A small Feather V2 writer and reader: Arrow IPC files of int64, float64
and utf8 columns without nulls.

The AV2 submission is a Feather file (``DataFrame.to_feather`` in the JAX
package), and so are the AV2 logs' poses, calibration and annotations
(``tools/create_av2_infos.py`` reads them with ``pandas.read_feather``).
The machine with the card has neither pandas nor pyarrow, so the port
handles the format itself: the Arrow IPC file layout (``ARROW1``, the
schema message, the record batch messages, the footer) with its
FlatBuffers metadata built and read by hand, following the Arrow format's
Schema.fbs, Message.fbs and File.fbs.

``write_feather`` writes one uncompressed record batch. ``read_feather``
reads every record batch the footer lists, uncompressed or with each buffer
LZ4-frame compressed (pyarrow's default for Feather V2; the LZ4 frame and
block formats are decoded here in Python, without checking the optional
xxHash checksums); a ZSTD-compressed file raises. Integer columns of any
width, float32 and float64, utf8 and large utf8 are read. ``num_rows`` reads
the row count from the footer.
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
_LARGE_UTF8 = 20
_DOUBLE = 2                               # Precision.DOUBLE
_LZ4_FRAME, _ZSTD = 0, 1                  # CompressionType


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


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def _lz4_block(src: bytes, pos: int, end: int, out: bytearray) -> None:
    """Decode one LZ4 block, src[pos:end], onto `out` (matches may reach
    back into what earlier blocks of the frame wrote)."""
    while pos < end:
        token = src[pos]
        pos += 1
        n = token >> 4
        if n == 15:
            while True:
                b = src[pos]
                pos += 1
                n += b
                if b != 255:
                    break
        out += src[pos:pos + n]
        pos += n
        if pos >= end:                  # the last sequence has no match
            break
        offset = src[pos] | src[pos + 1] << 8
        pos += 2
        n = (token & 15) + 4
        if n == 19:
            while True:
                b = src[pos]
                pos += 1
                n += b
                if b != 255:
                    break
        start = len(out) - offset
        if offset <= 0 or start < 0:
            raise ValueError('feather: corrupt LZ4 block')
        if n <= offset:
            out += out[start:start + n]
        else:                           # an overlapping (repeating) match
            for i in range(n):
                out.append(out[start + i])


def lz4_frame_decode(src: bytes) -> bytes:
    """The content of an LZ4 frame (the LZ4 frame format, version 01):
    the header's descriptor, then blocks, compressed or stored, until the
    end mark; block and content checksums are skipped."""
    if struct.unpack_from('<I', src, 0)[0] != 0x184D2204:
        raise ValueError('feather: not an LZ4 frame')
    flg = src[4]
    if flg >> 6 != 1:
        raise ValueError(f'feather: LZ4 frame version {flg >> 6}')
    pos = 6 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0) + 1
    block_checksum = bool(flg & 0x10)
    out = bytearray()
    while True:
        size = struct.unpack_from('<I', src, pos)[0]
        pos += 4
        if size == 0:
            break
        stored, size = bool(size & 0x80000000), size & 0x7FFFFFFF
        if stored:
            out += src[pos:pos + size]
        else:
            _lz4_block(src, pos, pos + size, out)
        pos += size + (4 if block_checksum else 0)
    return bytes(out)


def _column_type(footer: bytes, field) -> str:
    """A schema field's numpy dtype string, or 'utf8' / 'large_utf8'."""
    if field(4, None) is not None:
        raise ValueError('feather: dictionary-encoded columns are not read')
    tag, typ = field(2, 'B'), field(3, None)
    if tag == _INT:
        t = _read_table(footer, typ)
        bits, signed = t(0, 'i') or 0, bool(t(1, '?'))
        return f'<{"i" if signed else "u"}{bits // 8}'
    if tag == _FLOAT:
        precision = _read_table(footer, typ)(0, 'h') or 0
        if precision == 0:
            raise ValueError('feather: half-precision columns are not read')
        return '<f4' if precision == 1 else '<f8'
    if tag == _UTF8:
        return 'utf8'
    if tag == _LARGE_UTF8:
        return 'large_utf8'
    raise ValueError(f'feather: no reader for the Arrow type tag {tag}')


def read_feather(path: str) -> Dict[str, np.ndarray]:
    """{column name: 1-d numpy array} of a Feather V2 (Arrow IPC) file, in
    the schema's order, the record batches concatenated; utf8 columns come
    as object arrays of str, as ``pandas.read_feather`` gives them."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:6] != MAGIC or data[-6:] != MAGIC:
        raise ValueError(f'{path} is not an Arrow IPC (Feather V2) file')
    footer_len = struct.unpack_from('<i', data, len(data) - 10)[0]
    footer = data[len(data) - 10 - footer_len:len(data) - 10]
    root = _read_table(footer, struct.unpack_from('<I', footer, 0)[0])
    schema = _read_table(footer, root(1, None))
    fields_at = schema(1, None)
    names, types = [], []
    for i in range(struct.unpack_from('<I', footer, fields_at)[0]):
        at = fields_at + 4 + 4 * i
        field = _read_table(footer, at + struct.unpack_from('<I', footer,
                                                            at)[0])
        name_at = field(0, None)
        n = struct.unpack_from('<I', footer, name_at)[0]
        names.append(footer[name_at + 4:name_at + 4 + n].decode())
        types.append(_column_type(footer, field))
    dicts = root(2, None)
    if dicts is not None and struct.unpack_from('<I', footer, dicts)[0]:
        raise ValueError(f'{path}: dictionary batches are not read')

    parts: List[List[np.ndarray]] = [[] for _ in names]
    blocks = root(3, None)
    for b in range(struct.unpack_from('<I', footer, blocks)[0]):
        offset, meta_len, _ = struct.unpack_from('<qi4xq', footer,
                                                 blocks + 4 + 24 * b)
        skip = 8 if struct.unpack_from('<I', data, offset)[0] == CONTINUATION \
            else 4
        meta = data[offset + skip:offset + meta_len]
        message = _read_table(meta, struct.unpack_from('<I', meta, 0)[0])
        if message(1, 'B') != _RECORD_BATCH:
            raise ValueError(f'{path}: block {b} is not a record batch')
        batch = _read_table(meta, message(2, None))
        rows = batch(0, 'q') or 0
        nodes_at, bufs_at = batch(1, None), batch(2, None)
        codec = None
        if batch(3, None) is not None:
            codec = _read_table(meta, batch(3, None))(0, 'b') or _LZ4_FRAME
            if codec == _ZSTD:
                raise ValueError(f'{path}: ZSTD-compressed Feather buffers '
                                 'are not read (LZ4 frame and uncompressed '
                                 'are)')
        body = offset + meta_len

        def buffer(k: int) -> bytes:
            off, length = struct.unpack_from('<qq', meta, bufs_at + 4 + 16 * k)
            raw = data[body + off:body + off + length]
            if codec is None or not length:
                return raw
            size = struct.unpack_from('<q', raw, 0)[0]
            return raw[8:] if size == -1 else lz4_frame_decode(raw[8:])

        k = 0
        for col, kind in enumerate(types):
            length, nulls = struct.unpack_from('<qq', meta,
                                               nodes_at + 4 + 16 * col)
            if nulls:
                raise ValueError(f'{path}: column {names[col]!r} holds '
                                 f'{nulls} nulls, which are not read')
            k += 1                                      # the validity bitmap
            if kind in ('utf8', 'large_utf8'):
                offs = np.frombuffer(buffer(k), '<i4' if kind == 'utf8'
                                     else '<i8')[:length + 1]
                chars = buffer(k + 1)
                values = np.empty(length, object)
                for i in range(length):
                    values[i] = chars[offs[i]:offs[i + 1]].decode()
                k += 2
            else:
                values = np.frombuffer(buffer(k), kind)[:length].astype(
                    np.dtype(kind).newbyteorder('='))
                k += 1
            parts[col].append(values)
        if any(len(p[-1]) != rows for p in parts):
            raise ValueError(f'{path}: block {b} has columns of other '
                             'lengths than its row count')
    return {n: (np.concatenate(p) if p else np.zeros(0, object
                                                     if t.endswith('utf8')
                                                     else t))
            for n, t, p in zip(names, types, parts)}
