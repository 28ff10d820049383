"""Pure-NumPy reader and writer of TF1 checkpoint bundles (no TensorFlow
needed): a copy of `articulated_pose_tpu/utils/tf_bundle.py`, so the port
reads the reference's checkpoints without the JAX package.  A bundle that
either package writes reads back equal in both.

The reference trains with TF1 Saver checkpoints
(reference: lib/network.py:215-218 saves `tf_model.ckpt-<step>`, and
main.py:80-97 restores them); its downloadable pretrained models ship as
`<prefix>.index` + `<prefix>.data-00000-of-00001` bundles:

- `<prefix>.index` is a TensorBundle index: a leveldb-format SSTable
  (prefix-compressed key blocks + restart arrays, block handles, fixed
  48-byte footer with magic 0xdb4775248b80fb57) whose values are
  serialized BundleEntryProto messages (dtype, shape, shard, offset,
  size).  TensorFlow writes it uncompressed
  (tensor_bundle.cc: options.compression = kNoCompression).
- `<prefix>.data-NNNNN-of-MMMMM` shards hold the raw little-endian
  tensor bytes at the recorded offsets.

`read_bundle(prefix)` returns {tensor_name: np.ndarray}, the dict
`utils/tf_ckpt.load_reference_weights` consumes.  `write_bundle` writes
the same format (the tests' and `chip_smoke.py`'s fixtures).

CRC32C checksums are not verified (no hardware crc dependency); shapes
and byte sizes are cross-checked instead.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_FOOTER_SIZE = 48
_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (the subset Saver checkpoints use)
_DTYPES = {
    1: np.dtype("<f4"),    # DT_FLOAT
    2: np.dtype("<f8"),    # DT_DOUBLE
    3: np.dtype("<i4"),    # DT_INT32
    4: np.dtype("<u1"),    # DT_UINT8
    5: np.dtype("<i2"),    # DT_INT16
    6: np.dtype("<i1"),    # DT_INT8
    9: np.dtype("<i8"),    # DT_INT64
    10: np.dtype("bool"),  # DT_BOOL
    14: np.dtype("<u2"),   # DT_BFLOAT16 (raw 16-bit payload)
    19: np.dtype("<f2"),   # DT_HALF
    17: np.dtype("<u2"),   # DT_UINT16
    22: np.dtype("<u4"),   # DT_UINT32
    23: np.dtype("<u8"),   # DT_UINT64
}


# ---------------------------------------------------------------- varints


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """LEB128 varint at buf[pos:] -> (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


# ------------------------------------------------------- leveldb SSTable


def _read_block(data: bytes, offset: int, size: int) -> List[Tuple[bytes, bytes]]:
    """Decode one leveldb block -> list of (key, value) in order.

    The 1-byte compression type + 4-byte crc trailer follows the block
    contents; TensorBundle always writes type 0 (uncompressed).
    """
    comp = data[offset + size]
    if comp != 0:
        raise ValueError(
            f"compressed table block (type {comp}) — TensorBundle indexes "
            "are written uncompressed; refusing to guess")
    block = data[offset:offset + size]
    if len(block) < 4:
        raise ValueError("truncated block")
    (num_restarts,) = struct.unpack("<I", block[-4:])
    data_end = len(block) - 4 - 4 * num_restarts
    entries: List[Tuple[bytes, bytes]] = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _read_handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
    off, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return off, size, pos


def read_sstable(path: str) -> Dict[bytes, bytes]:
    """Read every (key, value) pair of a leveldb-format SSTable file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_SIZE:
        raise ValueError(f"{path}: too short for an SSTable footer")
    footer = data[-_FOOTER_SIZE:]
    (magic,) = struct.unpack("<Q", footer[40:48])
    if magic != _MAGIC:
        raise ValueError(f"{path}: bad SSTable magic {magic:#x}")
    pos = 0
    _, _, pos = _read_handle(footer, pos)          # metaindex (unused)
    index_off, index_size, _ = _read_handle(footer, pos)
    out: Dict[bytes, bytes] = {}
    for _, handle_bytes in _read_block(data, index_off, index_size):
        block_off, block_size, _ = _read_handle(handle_bytes)
        for key, value in _read_block(data, block_off, block_size):
            out[key] = value
    return out


# ------------------------------------------------------ protobuf (lite)


def _parse_fields(buf: bytes):
    """Yield (field_number, wire_type, value) from a protobuf message.

    Wire types: 0 varint (value int), 1 fixed64 (bytes), 2 length-
    delimited (bytes), 5 fixed32 (bytes).
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 1:
            v, pos = buf[pos:pos + 8], pos + 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v, pos = buf[pos:pos + ln], pos + ln
        elif wt == 5:
            v, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto -> dim tuple (field 2: repeated Dim{size=1})."""
    dims = []
    for field, _, v in _parse_fields(buf):
        if field == 2:                      # Dim submessage
            for f2, _, v2 in _parse_fields(v):
                if f2 == 1:                 # size (int64 varint)
                    if v2 >= 1 << 63:       # two's-complement negative
                        v2 -= 1 << 64
                    dims.append(v2)
    return tuple(dims)


class BundleEntry:
    __slots__ = ("dtype_code", "shape", "shard_id", "offset", "size")

    def __init__(self):
        self.dtype_code = 0
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0


def _parse_entry(buf: bytes) -> BundleEntry:
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5."""
    e = BundleEntry()
    for field, _, v in _parse_fields(buf):
        if field == 1:
            e.dtype_code = v
        elif field == 2:
            e.shape = _parse_shape(v)
        elif field == 3:
            e.shard_id = v
        elif field == 4:
            e.offset = v
        elif field == 5:
            e.size = v
    return e


def _parse_header(buf: bytes) -> int:
    """BundleHeaderProto -> num_shards (field 1); checks endianness=2."""
    num_shards = 1
    for field, wt, v in _parse_fields(buf):
        if field == 1:
            num_shards = v
        elif field == 2 and v != 0:         # 0 = LITTLE
            raise ValueError("big-endian checkpoint bundles are unsupported")
    return num_shards


# -------------------------------------------------------------- top level


def read_bundle_index(prefix: str):
    """Parse `<prefix>.index` -> ({tensor_name: BundleEntry}, num_shards).

    num_shards comes from the BundleHeaderProto (key "") when present —
    NOT from max(shard_id): a high-numbered shard holding no tensors
    (legal for sharded Savers) would otherwise make the -of-NNNNN file
    suffix wrong for every other shard.
    """
    table = read_sstable(prefix + ".index")
    entries: Dict[str, BundleEntry] = {}
    num_shards = None
    for key, value in table.items():
        if key == b"":
            num_shards = _parse_header(value)
            continue
        entries[key.decode("utf-8")] = _parse_entry(value)
    if not num_shards:
        num_shards = 1 + max((e.shard_id for e in entries.values()),
                             default=0)
    return entries, num_shards


def _shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def read_bundle(prefix: str) -> Dict[str, np.ndarray]:
    """Read a whole TF checkpoint bundle -> {tensor_name: array}.

    `prefix` is the checkpoint path without extension, e.g.
    `.../tf_model.ckpt-100000`.
    """
    entries, num_shards = read_bundle_index(prefix)
    shards: Dict[int, np.memmap] = {}
    out: Dict[str, np.ndarray] = {}
    for name, e in entries.items():
        if e.shard_id not in shards:
            path = _shard_path(prefix, e.shard_id, num_shards)
            if not os.path.exists(path) and num_shards == 1:
                # some exporters name the single shard -of-00001 even
                # when the header says otherwise; try common variants
                alt = f"{prefix}.data-00000-of-00001"
                path = alt if os.path.exists(alt) else path
            shards[e.shard_id] = np.memmap(path, dtype=np.uint8, mode="r")
        if e.dtype_code not in _DTYPES:
            raise ValueError(f"{name}: unsupported dtype enum {e.dtype_code}")
        dt = _DTYPES[e.dtype_code]
        n_elem = int(np.prod(e.shape, dtype=np.int64)) if e.shape else 1
        expect = n_elem * dt.itemsize
        if e.size != expect:
            raise ValueError(
                f"{name}: recorded byte size {e.size} != shape/dtype "
                f"product {expect}")
        raw = bytes(shards[e.shard_id][e.offset:e.offset + e.size])
        arr = np.frombuffer(raw, dtype=dt).reshape(e.shape)
        out[name] = arr
    return out


# ----------------------------------------------------- fixture writer


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _encode_block(entries: List[Tuple[bytes, bytes]],
                  restart_interval: int = 16) -> bytes:
    """leveldb block encoder with real prefix compression (for fixtures)."""
    out = bytearray()
    restarts = []
    prev = b""
    for i, (key, value) in enumerate(entries):
        if i % restart_interval == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while (shared < len(prev) and shared < len(key)
                   and prev[shared] == key[shared]):
                shared += 1
        _write_varint(out, shared)
        _write_varint(out, len(key) - shared)
        _write_varint(out, len(value))
        out += key[shared:]
        out += value
        prev = key
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    _write_varint(out, v)
    return bytes(out)


def _encode_tag(field: int, wt: int) -> bytes:
    return _encode_varint((field << 3) | wt)


def _encode_entry(e: BundleEntry) -> bytes:
    shape_buf = b"".join(
        _encode_tag(2, 2)
        + _encode_varint(len(dim_buf := _encode_tag(1, 0) + _encode_varint(d)))
        + dim_buf
        for d in e.shape)
    msg = (_encode_tag(1, 0) + _encode_varint(e.dtype_code)
           + _encode_tag(2, 2) + _encode_varint(len(shape_buf)) + shape_buf
           + _encode_tag(3, 0) + _encode_varint(e.shard_id)
           + _encode_tag(4, 0) + _encode_varint(e.offset)
           + _encode_tag(5, 0) + _encode_varint(e.size))
    return msg


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray],
                 block_size: int = 4096, num_shards: int = 1) -> None:
    """Write a TF-compatible bundle fixture (all tensors in shard 0).

    Produces `<prefix>.index` (real SSTable: prefix-compressed keys,
    restart arrays, multiple data blocks when entries exceed block_size,
    index block, footer+magic) and `<prefix>.data-00000-of-<num_shards>`.
    num_shards > 1 emulates a sharded Saver whose later shards hold no
    tensors — the header, not max(shard_id), must drive the file suffix.
    """
    names = sorted(tensors)
    data = bytearray()
    kvs: List[Tuple[bytes, bytes]] = []
    header = _encode_tag(1, 0) + _encode_varint(num_shards)
    kvs.append((b"", header))
    for name in names:
        arr = np.asarray(tensors[name])
        # ascontiguousarray promotes 0-d to 1-d; keep the true shape
        arr = np.ascontiguousarray(arr).reshape(arr.shape)
        code = next(c for c, dt in _DTYPES.items()
                    if dt == arr.dtype.newbyteorder("<"))
        e = BundleEntry()
        e.dtype_code = code
        e.shape = arr.shape
        e.shard_id = 0
        e.offset = len(data)
        e.size = arr.nbytes
        data += arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        kvs.append((name.encode(), _encode_entry(e)))

    # split into data blocks
    file_buf = bytearray()
    index_entries: List[Tuple[bytes, bytes]] = []
    cur: List[Tuple[bytes, bytes]] = []
    cur_bytes = 0

    def flush():
        nonlocal cur, cur_bytes, file_buf
        if not cur:
            return
        block = _encode_block(cur)
        off = len(file_buf)
        file_buf.extend(block)
        file_buf.append(0)                                # no compression
        file_buf += struct.pack("<I", 0)                  # crc (unchecked)
        index_entries.append(
            (cur[-1][0], _encode_varint(off) + _encode_varint(len(block))))
        cur, cur_bytes = [], 0

    for kv in kvs:
        cur.append(kv)
        cur_bytes += len(kv[0]) + len(kv[1]) + 8
        if cur_bytes >= block_size:
            flush()
    flush()

    meta_block = _encode_block([])
    meta_off = len(file_buf)
    file_buf.extend(meta_block)
    file_buf.append(0)
    file_buf += struct.pack("<I", 0)
    index_block = _encode_block(index_entries)
    index_off = len(file_buf)
    file_buf.extend(index_block)
    file_buf.append(0)
    file_buf += struct.pack("<I", 0)
    footer = bytearray()
    _write_varint(footer, meta_off)
    _write_varint(footer, len(meta_block))
    _write_varint(footer, index_off)
    _write_varint(footer, len(index_block))
    footer += b"\0" * (40 - len(footer))
    footer += struct.pack("<Q", _MAGIC)
    file_buf += footer

    with open(prefix + ".index", "wb") as f:
        f.write(file_buf)
    with open(_shard_path(prefix, 0, num_shards), "wb") as f:
        f.write(data)
