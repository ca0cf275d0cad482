"""The JAX trainer's orbax checkpoints, read and written with numpy alone
(counterpart of the orbax half of ``waveverify_tpu/train/checkpoint.py``).

An orbax PyTree checkpoint, as ``save_checkpoint`` of the JAX package
writes it, is a tag directory::

    <tag>/meta.json                 host state (step, controllers, model_config)
    <tag>/state/_METADATA           JSON: the tree's paths and leaf types
    <tag>/state/_CHECKPOINT_METADATA
    <tag>/state/manifest.ocdbt      an OCDBT key-value store: its manifest,
    <tag>/state/d/...               b-tree nodes and data files (a second,
    <tag>/state/ocdbt.process_0/    per-process store beside it, which the
                                    root's nodes point into)

The store holds one zarr v2 array per leaf: ``<path>/.zarray`` (JSON) and
its chunks ``<path>/0.0...``, each a zstd frame. This module reads those
layers in order:

- zstd, through the system's ``libzstd.so.1`` (``ctypes``; no header, no
  Python package). A missing library raises, naming it.
- OCDBT (tensorstore's b-tree format): the manifest's config and newest
  version, then the b-tree from that version's root: interior and leaf
  nodes with prefix-compressed keys, values inline in a leaf or indirect
  (data file, offset, length), data-file paths relative to the base path
  of the node or manifest that names them. Every manifest and node ends in
  a CRC-32C of its bytes, checked on read.
- zarr v2: dtype, shape, chunks, order, compressor (zstd or none) and fill
  value; the chunks assembled into one array, an absent chunk taking the
  fill value.

:func:`read_state` returns the whole tree as nested dicts and lists of
numpy arrays (``None`` where orbax stored no value, e.g. optax's masked
leaves), as orbax's structure-free restore does; :func:`read_params`
returns ``wm_params`` alone. :func:`write_state` writes such a tree as an
orbax checkpoint (one OCDBT store, zstd nodes and chunks) that orbax
restores. Nothing here imports JAX, orbax or tensorstore.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import json
import math
import shutil
import struct
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

ZSTD_SONAME = "libzstd.so.1"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE_VALUE_BYTES = 1024  # orbax's OCDBT config
MAX_DECODED_NODE_BYTES = 100_000_000
_MISSING = 2 ** 64 - 1  # the offset and length of an empty tree's root

# -- zstd -------------------------------------------------------------------------

_zstd: Optional[ctypes.CDLL] = None


class _Buffer(ctypes.Structure):  # ZSTD_inBuffer / ZSTD_outBuffer
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def zstd_library() -> ctypes.CDLL:
    """The system's libzstd (``find_library("zstd")``, then the soname);
    raises ``OSError`` naming it when neither loads."""
    global _zstd
    if _zstd is not None:
        return _zstd
    names = [n for n in (ctypes.util.find_library("zstd"), ZSTD_SONAME) if n]
    errors = []
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError as e:
            errors.append(f"{name}: {e}")
    else:
        raise OSError(
            f"orbax checkpoints are zstd-compressed, and {ZSTD_SONAME} (the "
            "system's zstd library) could not be loaded ("
            + ("; ".join(errors) or "not found") + "). Install it (Debian / "
            "Ubuntu: libzstd1) to read or write them.")
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, size_t]
    lib.ZSTD_createDCtx.restype = vp
    lib.ZSTD_decompressDCtx.restype = size_t
    lib.ZSTD_decompressDCtx.argtypes = [vp, vp, size_t, ctypes.c_char_p, size_t]
    lib.ZSTD_compressBound.restype = size_t
    lib.ZSTD_compressBound.argtypes = [size_t]
    lib.ZSTD_compress.restype = size_t
    lib.ZSTD_compress.argtypes = [vp, size_t, ctypes.c_char_p, size_t, ctypes.c_int]
    lib.ZSTD_DCtx_reset.restype = size_t
    lib.ZSTD_DCtx_reset.argtypes = [vp, ctypes.c_int]
    lib.ZSTD_decompressStream.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_Buffer),
                                          ctypes.POINTER(_Buffer)]
    lib.dctx = lib.ZSTD_createDCtx()  # one context, reused by every call
    _zstd = lib
    return lib


def zstd_info() -> Tuple[str, str]:
    """(the loaded library's file, its version "major.minor.patch")."""
    lib = zstd_library()
    v = lib.ZSTD_versionNumber()
    path = lib._name
    try:  # the file the dynamic loader chose
        for line in Path("/proc/self/maps").read_text().splitlines():
            if "libzstd" in line:
                path = line.split()[-1]
                break
    except OSError:
        pass
    return path, f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"{what}: zstd error {lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_decompress(data: bytes, size_hint: Optional[int] = None) -> bytes:
    """One zstd frame's content (streamed where the frame does not record
    its size, as tensorstore writes them; ``size_hint`` sizes the first
    output buffer)."""
    lib = zstd_library()
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == 2 ** 64 - 2:
        raise ValueError("not a zstd frame")
    if size != 2 ** 64 - 1:
        out = np.empty(max(int(size), 1), np.uint8)
        n = _check(lib, lib.ZSTD_decompressDCtx(lib.dctx, out.ctypes.data, size,
                                                data, len(data)), "zstd decompress")
        return out[:n].tobytes()
    _check(lib, lib.ZSTD_DCtx_reset(lib.dctx, 1), "zstd reset")  # session only
    src = ctypes.c_char_p(data)
    inb = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    cap = max(size_hint or 4 * len(data), 1 << 12)
    parts = []
    while True:
        out = np.empty(cap, np.uint8)
        outb = _Buffer(out.ctypes.data, cap, 0)
        left = _check(lib, lib.ZSTD_decompressStream(
            lib.dctx, ctypes.byref(outb), ctypes.byref(inb)), "zstd decompress")
        parts.append(out[:outb.pos].tobytes())
        if left == 0:
            return b"".join(parts)
        if inb.pos == inb.size and outb.pos < cap:
            raise ValueError("zstd decompress: truncated frame")


def zstd_compress(data: bytes, level: int = 1) -> bytes:
    lib = zstd_library()
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(out, cap, data, len(data), level),
               "zstd compress")
    return out.raw[:n]


# -- CRC-32C (Castagnoli), the OCDBT footer ----------------------------------------

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    table, c = _CRC_TABLE, 0xFFFFFFFF
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# -- OCDBT ---------------------------------------------------------------------------

class _Cursor:
    """Little-endian fields and LEB128 varints of a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                return value
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _unframe(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file: header (magic, length,
    version, compression), body, CRC-32C footer."""
    if len(raw) < 18:
        raise ValueError(f"{what}: too short ({len(raw)} bytes)")
    head = _Cursor(raw, what)
    got = struct.unpack(">I", head.take(4))[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = head.u64()
    if length != len(raw):
        raise ValueError(f"{what}: header says {length} bytes, read {len(raw)}")
    footer = struct.unpack("<I", raw[-4:])[0]
    crc = crc32c(raw[:-4])
    if crc != footer:
        raise ValueError(f"{what}: CRC-32C mismatch (stored {footer:#010x}, "
                         f"computed {crc:#010x})")
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}")
    compression = head.varint()
    body = raw[head.pos:-4]
    if compression == 1:
        return zstd_decompress(body)
    if compression == 0:
        return body
    raise ValueError(f"{what}: unknown compression {compression}")


def _frame(body: bytes, magic: int) -> bytes:
    """Inverse of :func:`_unframe`, zstd-compressed."""
    payload = _varint(0) + _varint(1) + zstd_compress(body, 0)
    total = 4 + 8 + len(payload) + 4
    raw = struct.pack(">I", magic) + struct.pack("<Q", total) + payload
    return raw + struct.pack("<I", crc32c(raw))


def _read_file_table(cur: _Cursor, base: str) -> List[Tuple[str, str]]:
    """A data-file table: for each file, (its path relative to the store's
    root, the base path a node read from it passes on to its own table).
    A path is ``base`` (the base path of the node or manifest holding the
    table) + the entry's base path + its relative path; the entries' full
    paths are prefix-compressed."""
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    files, prev = [], b""
    for p, s, b in zip(prefix, suffix, base_len):
        prev = prev[:p] + cur.take(s)
        name = prev.decode()
        if b > len(name) or name.startswith("/") or ".." in Path(name).parts:
            raise ValueError(f"{cur.what}: bad data file path {name!r}")
        files.append((base + name, base + name[:b]))
    return files


def _keys(cur: _Cursor, n: int, extra: bool = False) -> Tuple[List[bytes], List[int]]:
    """``n`` prefix-compressed keys (and, for interior nodes, each
    entry's subtree common prefix length)."""
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    common = cur.varints(n) if extra else []
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + cur.take(s)
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The newest version of an OCDBT store in directory ``root``: its keys
    and values (values read when asked for)."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        body = _unframe(self._read("manifest.ocdbt"), MANIFEST_MAGIC,
                        f"{self.root}/manifest.ocdbt")
        cur = _Cursor(body, f"{self.root}/manifest.ocdbt")
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise ValueError(f"{cur.what}: numbered manifests (kind {kind}) "
                             "are not read")
        cur.varint()  # max_inline_value_bytes
        self.max_decoded_node_bytes = cur.varint()
        cur.u8()  # version_tree_arity_log2
        compression = cur.varint()
        if compression == 1:
            cur.u32()  # zstd level
        elif compression != 0:
            raise ValueError(f"{cur.what}: unknown compression {compression}")
        files = _read_file_table(cur, "")
        # the version tree's newest leaf entries are inline in the manifest
        n = cur.varint()
        if n == 0:
            raise ValueError(f"{cur.what}: no versions")
        generation = cur.varints(n)
        height = [cur.u8() for _ in range(n)]
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        newest = max(range(n), key=generation.__getitem__)
        self._values: Dict[bytes, Any] = {}
        if length[newest] != _MISSING:
            self._walk(files[file_id[newest]], offset[newest], length[newest],
                       height[newest], b"")

    def _read(self, name: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        path = self.root / name
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read() if length is None else f.read(length)
        except FileNotFoundError:
            raise FileNotFoundError(f"OCDBT store {self.root}: no file {name}") from None
        if length is not None and len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} asked, "
                             f"{len(data)} there")
        return data

    def _walk(self, file: Tuple[str, str], offset: int, length: int,
              height: int, prefix: bytes) -> None:
        name, base = file
        what = f"{self.root}/{name}@{offset}:{length}"
        body = _unframe(self._read(name, offset, length), NODE_MAGIC, what)
        if len(body) > self.max_decoded_node_bytes:
            raise ValueError(f"{what}: node of {len(body)} bytes")
        cur = _Cursor(body, what)
        if cur.u8() != height:
            raise ValueError(f"{what}: node height differs from its reference")
        files = _read_file_table(cur, base)
        n = cur.varint()
        if height == 0:
            keys, _ = _keys(cur, n)
            lengths = cur.varints(n)
            kinds = cur.varints(n)
            if set(kinds) - {0, 1}:
                raise ValueError(f"{what}: unknown value kind")
            m = sum(kinds)
            ids, offsets = cur.varints(m), cur.varints(m)
            j = 0
            for key, size, kind in zip(keys, lengths, kinds):
                if kind:
                    self._values[prefix + key] = (files[ids[j]][0], offsets[j], size)
                    j += 1
                else:
                    self._values[prefix + key] = cur.take(size)
            if cur.pos != len(body):
                raise ValueError(f"{what}: {len(body) - cur.pos} bytes after the entries")
            return
        keys, common = _keys(cur, n, extra=True)
        ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
        for key, c, i, o, size in zip(keys, common, ids, offsets, lengths):
            self._walk(files[i], o, size, height - 1, prefix + key[:c])

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def __contains__(self, key: Union[str, bytes]) -> bool:
        return _b(key) in self._values

    def read(self, key: Union[str, bytes]) -> bytes:
        value = self._values.get(_b(key))
        if value is None:
            raise KeyError(f"OCDBT store {self.root}: no key {_b(key).decode()!r}")
        if isinstance(value, tuple):
            return self._read(*value)
        return value


def _b(key: Union[str, bytes]) -> bytes:
    return key.encode() if isinstance(key, str) else key


def write_store(root: Union[str, Path], items: Dict[str, bytes]) -> None:
    """Write ``items`` as a one-version OCDBT store in directory ``root``:
    the values over ``MAX_INLINE_VALUE_BYTES`` and then the one leaf node
    in one data file, and the manifest, zstd-compressed as orbax's."""
    root = Path(root)
    entries = sorted((_b(k), v) for k, v in items.items())
    data = bytearray()
    lengths, kinds, offsets, inline = [], [], [], bytearray()
    for _, value in entries:
        lengths.append(len(value))
        if len(value) > MAX_INLINE_VALUE_BYTES:
            kinds.append(1)
            offsets.append(len(data))
            data += value
        else:
            kinds.append(0)
            inline += value
    digest = hashlib.sha256(b"".join(k + b"\0" + v for k, v in entries)).hexdigest()
    file_name = f"d/{digest[:32]}".encode()
    table = _varint(1) + _varint(len(file_name)) + _varint(0) + file_name
    keys = [k for k, _ in entries]
    prefix = [len(_common(a, b)) for a, b in zip(keys, keys[1:])]
    node = bytearray(b"\x00" + table + _varint(len(keys)))
    node += b"".join(map(_varint, prefix))
    node += b"".join(_varint(len(k) - p) for k, p in zip(keys, [0] + prefix))
    node += b"".join(k[p:] for k, p in zip(keys, [0] + prefix))
    node += b"".join(map(_varint, lengths)) + b"".join(map(_varint, kinds))
    node += b"".join(_varint(0) for _ in offsets) + b"".join(map(_varint, offsets))
    node += inline
    if len(node) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"one leaf node of {len(node)} bytes: too large")
    node_raw = _frame(bytes(node), NODE_MAGIC)
    node_offset = len(data)
    data += node_raw
    manifest = bytearray(bytes.fromhex(digest[32:64]))  # uuid
    manifest += (_varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
                 + _varint(MAX_DECODED_NODE_BYTES) + b"\x04" + _varint(1)
                 + struct.pack("<i", 0))
    manifest += table
    manifest += (_varint(1) + _varint(1) + b"\x00" + _varint(0)
                 + _varint(node_offset) + _varint(len(node_raw))
                 + _varint(len(keys)) + _varint(len(node_raw))
                 + _varint(sum(lengths[i] for i, k in enumerate(kinds) if k))
                 + struct.pack("<Q", time.time_ns()))
    manifest += _varint(0)  # no version-tree nodes
    (root / "d").mkdir(parents=True, exist_ok=True)
    (root / file_name.decode()).write_bytes(bytes(data))
    (root / "manifest.ocdbt").write_bytes(_frame(bytes(manifest), MANIFEST_MAGIC))


def _common(a: bytes, b: bytes) -> bytes:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return a[:n]


# -- zarr v2 -----------------------------------------------------------------------

# the dtypes of the JAX trainer's leaves, by their zarr v2 names
_DTYPES = {"<f4": "<f4", "<f8": "<f8", "<i4": "<i4", "<i8": "<i8", "|b1": "?"}


def _dtype(name: str) -> Tuple[np.dtype, bool]:
    """(the numpy dtype a chunk's bytes hold, whether they are bfloat16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    if name not in _DTYPES:
        raise ValueError(f"zarr dtype {name!r} is not read")
    return np.dtype(_DTYPES[name]), False


def _fill(value: Any, dtype: np.dtype, bf16: bool) -> Any:
    if value is None:
        return 0
    if isinstance(value, str):  # zarr's names of the float specials
        value = {"NaN": math.nan, "Infinity": math.inf,
                 "-Infinity": -math.inf}[value]
    if bf16:
        return int(np.array(value, np.float32).view(np.uint32) >> 16)
    return value


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``: chunks assembled, absent
    chunks filled, bfloat16 widened to float32 (exactly)."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}")
    dtype, bf16 = _dtype(meta["dtype"])
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r} is not read")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{name}: order {order!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in (np.ndindex(*[len(g) for g in grid]) if shape else [()]):
        key = f"{name}/{sep.join(map(str, index)) or '0'}"
        if key not in store:
            continue
        raw = store.read(key)
        if comp is not None:
            raw = zstd_decompress(raw, int(np.prod(chunks)) * dtype.itemsize)
        want = int(np.prod(chunks)) * dtype.itemsize
        if len(raw) != want:
            raise ValueError(f"{key}: {len(raw)} bytes, expected {want}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(index, chunks, shape))
        out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
    if bf16:
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


def _zarr_items(name: str, value: np.ndarray) -> Dict[str, bytes]:
    """The ``.zarray`` and the one chunk of ``value``, as orbax writes them."""
    arr = np.asarray(value)
    kind = {np.dtype(np.bool_): "|b1"}.get(arr.dtype, arr.dtype.newbyteorder("<").str)
    if kind not in _DTYPES:
        raise ValueError(f"{name}: dtype {arr.dtype} is not written")
    shape = list(arr.shape)
    meta = {"chunks": [max(1, s) for s in shape],
            "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
            "dtype": kind, "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    chunk = ".".join("0" for _ in shape) or "0"
    return {f"{name}/.zarray": json.dumps(meta, sort_keys=True,
                                          separators=(",", ":")).encode(),
            f"{name}/{chunk}": zstd_compress(arr.astype(kind).tobytes(), 1)}


# -- orbax PyTree checkpoints --------------------------------------------------------

def _leaves(tree: Any, path: Tuple[Tuple[str, int], ...] = ()
            ) -> Iterable[Tuple[Tuple[Tuple[str, int], ...], Any]]:
    """(path of (key, orbax key type), leaf): 2 for a dict key, 1 for a
    sequence index."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + ((str(k), 2),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + ((str(i), 1),))
    else:
        yield path, tree


class _Seq(dict):
    """A sequence being assembled, by index: a list once complete."""


def _insert(tree: Dict[str, Any], path: List[Tuple[str, int]], value: Any) -> None:
    node = tree
    for (key, _), (_, child_type) in zip(path, path[1:]):
        node = node.setdefault(key, {} if child_type == 2 else _Seq())
    node[path[-1][0]] = value


def _lists(node: Any) -> Any:
    """The tree :func:`_insert` built, its sequences as lists."""
    if isinstance(node, _Seq):
        return [_lists(node[str(i)]) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _lists(v) for k, v in node.items()}
    return node


def _read_meta(tag_dir: Path) -> Dict[str, Any]:
    meta = tag_dir / "meta.json"
    return json.loads(meta.read_text()) if meta.exists() else {}


def read_state(tag_dir: Union[str, Path], only: Optional[str] = None
               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the checkpoint's tree, its ``meta.json``) of an orbax tag directory:
    nested dicts (and lists, for tuples) of numpy arrays, ``None`` where
    orbax stored no value; ``only`` keeps one top-level field."""
    tag_dir = Path(tag_dir)
    state_dir = tag_dir / "state"
    if not (state_dir / "_METADATA").exists():
        raise FileNotFoundError(f"no orbax state under {tag_dir}")
    md = json.loads((state_dir / "_METADATA").read_text())
    if not md.get("use_ocdbt", False) or md.get("use_zarr3", False):
        raise ValueError(f"{state_dir}: only OCDBT + zarr v2 checkpoints are read "
                         f"(use_ocdbt {md.get('use_ocdbt')}, use_zarr3 "
                         f"{md.get('use_zarr3')})")
    store = OcdbtStore(state_dir)
    tree: Dict[str, Any] = {}
    for entry in md["tree_metadata"].values():
        path = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        if only is not None and path[0][0] != only:
            continue
        if {t for _, t in path} - {1, 2}:
            raise ValueError(f"{state_dir}: key types {path} are not read")
        vm = entry["value_metadata"]
        kind = vm.get("value_type")
        if vm.get("skip_deserialize") or kind == "None":
            value = None
        elif kind == "np.ndarray":
            value = read_array(store, ".".join(k for k, _ in path))
        else:
            raise ValueError(f"{state_dir}: leaf type {kind!r} at {path} is not read")
        _insert(tree, path, value)
    if only is not None and only not in tree:
        raise KeyError(f"{tag_dir}: the checkpoint has no {only!r} field")
    return _lists(tree), _read_meta(tag_dir)


def read_params(tag_dir: Union[str, Path]) -> Dict[str, Any]:
    """The ``wm_params`` field alone (the networks' weights; counterpart
    of ``load_params``)."""
    return read_state(tag_dir, only="wm_params")[0]["wm_params"]


def write_state(tag_dir: Union[str, Path], tree: Dict[str, Any],
                meta: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``tree`` (nested dicts / lists of numpy arrays) as an orbax
    PyTree checkpoint in ``tag_dir`` (``state/`` and ``meta.json``),
    through a temporary directory renamed into place."""
    tag_dir = Path(tag_dir)
    tmp = tag_dir.parent / f".tmp_{tag_dir.name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    state_dir = tmp / "state"
    state_dir.mkdir(parents=True)
    items: Dict[str, bytes] = {}
    tree_md = {}
    for path, value in _leaves(tree):
        keys = tuple(k for k, _ in path)
        tree_md[repr(keys)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in path],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
        items.update(_zarr_items(".".join(keys), np.asarray(value)))
    write_store(state_dir, items)
    (state_dir / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree_md, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    now = time.time_ns()
    (state_dir / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": "orbax.checkpoint._src.handlers."
                         "pytree_checkpoint_handler.PyTreeCheckpointHandler",
        "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": now,
        "commit_timestamp_nsecs": now, "custom_metadata": {}}))
    (tmp / "meta.json").write_text(json.dumps(meta or {}, default=str))
    if tag_dir.exists():
        shutil.rmtree(tag_dir)
    tmp.rename(tag_dir)
    return tag_dir
