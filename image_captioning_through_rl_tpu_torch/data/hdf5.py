"""A numpy reader and writer for the HDF5 files of the COCO bundle.

The bundle's ``.h5`` tables are what h5py writes by default: superblock
version 0 with 8-byte offsets and lengths, the root group as a symbol table
(a version 1 B-tree of "SNOD" nodes over a local "HEAP" of names), version
1 object headers and contiguous, unfiltered storage. This module reads and
writes exactly that layout, so the port needs no ``h5py``:

  * :func:`read_h5` gives ``{name: ndarray}`` for the datasets of the root
    group, each read by one ``np.fromfile(path, offset=...)``. It takes
    dataspace messages of versions 1 and 2, little-endian integers of 1-8
    bytes and IEEE float32 / float64, and the layout message of version 3
    with contiguous storage; a dataset whose storage address is undefined
    (h5py writes a 0-row dataset so) reads as zeros of its shape.
    Fill-value, modification-time, NIL and attribute messages are skipped.
    Anything else raises a ``ValueError`` that names the file, the dataset
    and the reason: chunked or compact storage, a filter pipeline (gzip),
    external storage, big-endian, string, compound or variable-length
    types, any superblock version but 0, a nested group.
  * :func:`write_h5` writes ``{name: ndarray}`` in the same layout,
    published atomically; h5py and libhdf5 open its files.

Layout facts (the HDF5 file format specification, version 0 superblock):
a group's names are sorted (byte order) within each SNOD of up to 2 x 4
entries; a B-tree node holds up to 2 x 16 children, and key ``i`` is the
heap offset of the largest name left of child ``i`` (key 0 the empty name
at heap offset 0): libhdf5 finds ``f[name]`` by that search. A local heap
with no free block has the free-list head 1. The superblock's end-of-file
address is the file's length.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..utils.io import atomic_path

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
LEAF_K, INTERNAL_K = 4, 16  # h5py's defaults: 8 entries a SNOD, 32 children a node
FREE_NULL = 1  # H5HL_FREE_NULL: the local heap has no free block
SUPERBLOCK_SIZE = 96
ENTRY_SIZE = 40  # a symbol table entry with 8-byte offsets
SNOD_SIZE = 8 + 2 * LEAF_K * ENTRY_SIZE
TREE_SIZE = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
HEAP_HEADER = 32

# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL = 0x00, 0x01, 0x02, 0x03, 0x04, 0x05
LINK, EXTERNAL, LAYOUT, GROUP_INFO, FILTERS, ATTRIBUTE = 0x06, 0x07, 0x08, 0x0A, 0x0B, 0x0C
MTIME_OLD, CONTINUATION, SYMBOL_TABLE, MTIME = 0x0E, 0x10, 0x11, 0x12
SKIPPED = {NIL, FILL_OLD, FILL, ATTRIBUTE, MTIME_OLD, MTIME}

TYPE_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumerated", 9: "variable-length", 10: "array"}
# IEEE layouts: size -> (precision, exponent location, exponent size, mantissa
# location, mantissa size, exponent bias, sign location)
IEEE = {4: (32, 23, 8, 0, 23, 127, 31), 8: (64, 52, 11, 0, 52, 1023, 63)}


class _Reader:
    """Metadata reads of one file; every error names the file (and the
    dataset, once known)."""

    def __init__(self, path: str):
        self.path = path
        self.size = os.path.getsize(path)
        self._f = open(path, "rb")
        self.base = 0
        self.where = ""

    def close(self) -> None:
        self._f.close()

    def fail(self, reason: str):
        raise ValueError(f"{self.path}: {self.where}{reason}")

    def read(self, addr: int, n: int) -> bytes:
        addr += self.base
        if addr + n > self.size:
            self.fail(f"{n} bytes at {addr} run past the end of the file ({self.size} bytes)")
        self._f.seek(addr)
        return self._f.read(n)

    def superblock(self) -> int:
        """Checks the superblock; returns the root group's object header
        address."""
        head = self.read(0, 24)
        if head[:8] != SIGNATURE:
            self.fail("not an HDF5 file (no signature at offset 0)")
        if head[8] != 0:
            self.fail(f"superblock version {head[8]} (only version 0 is read)")
        if head[13] != 8 or head[14] != 8:
            self.fail(f"{head[13]}-byte offsets and {head[14]}-byte lengths (only 8 are read)")
        block = self.read(24, SUPERBLOCK_SIZE - 24)
        self.base, _, eof, _ = struct.unpack_from("<4Q", block, 0)
        if self.base + eof > self.size:
            self.fail(f"truncated: the superblock says {eof} bytes, the file holds {self.size}")
        return struct.unpack_from("<Q", block, 32 + 8)[0]

    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """The messages ``(type, flags, data)`` of the version 1 object
        header at ``addr``, continuation blocks followed."""
        head = self.read(addr, 16)
        if head[0] != 1:
            self.fail(f"object header version {head[0]} at {addr} (only version 1 is read)")
        total, _, first = struct.unpack_from("<HII", head, 2)
        blocks, out, seen = [(addr + 16, first)], [], 0
        while blocks and seen < total:
            start, length = blocks.pop(0)
            buf = self.read(start, length)
            pos = 0
            while pos + 8 <= length and seen < total:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8: pos + 8 + msize]
                pos += 8 + msize
                seen += 1
                if mflags & 0x02:
                    self.fail(f"a shared header message (type {mtype:#x})")
                if mtype == CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                else:
                    out.append((mtype, mflags, data))
        return out

    def group(self, header: int) -> List[Tuple[str, int, int]]:
        """``(name, object header address, cache type)`` of every entry of
        the symbol-table group whose object header is at ``header``."""
        msgs = {t: d for t, _, d in self.messages(header)}
        if SYMBOL_TABLE not in msgs:
            if {LINK, LINK_INFO, GROUP_INFO} & msgs.keys():
                self.fail("a group stored as links (only symbol-table groups are read)")
            self.fail("the root object is not a group")
        btree, heap = struct.unpack_from("<QQ", msgs[SYMBOL_TABLE])
        hh = self.read(heap, HEAP_HEADER)
        if hh[:4] != b"HEAP":
            self.fail(f"no local heap at {heap}")
        size, _, data_addr = struct.unpack_from("<QQQ", hh, 8)
        names = self.read(data_addr, size)
        entries: List[Tuple[str, int, int]] = []
        self._tree(btree, names, entries)
        return entries

    def _tree(self, addr: int, names: bytes, out: list) -> None:
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            self.fail(f"no group B-tree node at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self.read(addr + 24, (2 * used + 1) * 8)
        for i in range(used):
            child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
            if level > 0:
                self._tree(child, names, out)
                continue
            sn = self.read(child, 8)
            if sn[:4] != b"SNOD":
                self.fail(f"no symbol table node at {child}")
            count = struct.unpack_from("<H", sn, 6)[0]
            raw = self.read(child + 8, count * ENTRY_SIZE)
            for j in range(count):
                off, obj, cache = struct.unpack_from("<QQI", raw, j * ENTRY_SIZE)
                out.append((names[off: names.index(b"\0", off)].decode(), obj, cache))


def _dataspace(r: _Reader, data: bytes) -> Tuple[int, ...]:
    version, rank = data[0], data[1]
    if version == 1:
        start = 8
    elif version == 2:
        if data[3] == 2:
            r.fail("a null dataspace")
        start = 4
    else:
        r.fail(f"dataspace message version {version}")
    return struct.unpack_from(f"<{rank}Q", data, start)


def _datatype(r: _Reader, data: bytes) -> np.dtype:
    cls, bits0, sign = data[0] & 0x0F, data[1], data[2]
    size = struct.unpack_from("<I", data, 4)[0]
    if cls in TYPE_CLASSES:
        r.fail(f"a {TYPE_CLASSES[cls]} datatype (only integers and IEEE floats are read)")
    if cls not in (0, 1):
        r.fail(f"datatype class {cls}")
    if bits0 & 0x01 or (cls == 1 and bits0 & 0x40):
        r.fail("a big-endian datatype (only little-endian is read)")
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", data, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            r.fail(f"a {size}-byte integer of {precision} bits at offset {offset}")
        return np.dtype(f"<{'i' if bits0 & 0x08 else 'u'}{size}")
    props = struct.unpack_from("<HHBBBBI", data, 8)
    if size not in IEEE or (props[0], *props[1:]) != (0, *IEEE[size][:6]) or sign != IEEE[size][6]:
        r.fail(f"a {size}-byte float that is not IEEE float32 or float64")
    return np.dtype(f"<f{size}")


def _dataset(r: _Reader, header: int):
    """``(shape, dtype, address or None)`` of the dataset at ``header``."""
    msgs: Dict[int, bytes] = {}
    for mtype, _, data in r.messages(header):
        if mtype in SKIPPED:
            continue
        if mtype == SYMBOL_TABLE or mtype in (LINK, LINK_INFO, GROUP_INFO):
            r.fail("a nested group (only datasets in the root group are read)")
        if mtype == FILTERS:
            r.fail("a filter pipeline (compressed or filtered storage)")
        if mtype == EXTERNAL:
            r.fail("external storage")
        if mtype not in (DATASPACE, DATATYPE, LAYOUT):
            r.fail(f"header message type {mtype:#x}")
        msgs[mtype] = data
    missing = {DATASPACE, DATATYPE, LAYOUT} - msgs.keys()
    if missing:
        r.fail(f"no dataspace, datatype or layout message ({sorted(missing)})")
    shape, dtype = _dataspace(r, msgs[DATASPACE]), _datatype(r, msgs[DATATYPE])
    lay = msgs[LAYOUT]
    if lay[0] != 3:
        r.fail(f"layout message version {lay[0]} (only version 3 is read)")
    kind = {0: "compact", 2: "chunked", 3: "virtual"}.get(lay[1])
    if kind:
        r.fail(f"{kind} storage (only contiguous storage is read)")
    addr, size = struct.unpack_from("<QQ", lay, 2)
    want = math.prod(shape) * dtype.itemsize
    if addr == UNDEF:
        return shape, dtype, None
    if size != want:
        r.fail(f"contiguous storage of {size} bytes for {want} bytes of data")
    if r.base + addr + size > r.size:
        r.fail(f"data at {addr} runs past the end of the file")
    return shape, dtype, r.base + addr


def read_h5(path: str, names: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """The datasets of the root group of the HDF5 file at ``path`` (all of
    them, in name order, or those of ``names``), as numpy arrays."""
    path = os.fspath(path)
    r = _Reader(path)
    try:
        entries = r.group(r.superblock())
        found = {name: (obj, cache) for name, obj, cache in entries}
        for name in names or []:
            if name not in found:
                raise KeyError(f"{path}: no dataset {name!r} (has {sorted(found)})")
        plan = {}
        for name in sorted(found) if names is None else names:
            obj, cache = found[name]
            r.where = f"dataset {name!r}: "
            if cache == 1:
                r.fail("a nested group (only datasets in the root group are read)")
            plan[name] = _dataset(r, obj)
    finally:
        r.close()
    out = {}
    for name, (shape, dtype, addr) in plan.items():
        if addr is None:
            out[name] = np.zeros(shape, dtype)
        else:
            out[name] = np.fromfile(path, dtype=dtype, count=math.prod(shape),
                                    offset=addr).reshape(shape)
    return out


# ---- the writer ----


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _message(mtype: int, flags: int, data: bytes) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _type_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = 0x08 if dtype.kind == "i" else 0
        return _message(DATATYPE, 1, struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size))
    if dtype.kind == "f" and size in IEEE:
        prec, eloc, esize, mloc, msize, bias, sign = IEEE[size]
        return _message(DATATYPE, 1, struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, size, 0,
                                                 prec, eloc, esize, mloc, msize, bias))
    raise ValueError(f"dtype {dtype} (only int8-64, uint8-64, float32 and float64 are written)")


def _dataset_header(shape: Tuple[int, ...], dtype: np.dtype, addr: int, nbytes: int) -> bytes:
    rank = len(shape)
    space = struct.pack(f"<BBBB4x{2 * rank}Q", 1, rank, 1, 0, *shape, *shape)
    msgs = (_message(DATASPACE, 0, space) + _type_message(dtype)
            + _message(FILL, 1, bytes([2, 2, 2, 1, 0, 0, 0, 0]))
            + _message(LAYOUT, 0, struct.pack("<BBQQ", 3, 1, addr, nbytes)))
    return struct.pack("<BxHII4x", 1, 4, 1, len(msgs)) + msgs


def _tree_levels(n_snods: int) -> List[List[List[int]]]:
    """The B-tree's nodes by level from the leaves up, each node its list
    of child indices in the level below (SNODs for level 0)."""
    levels, width = [], max(n_snods, 0)
    while True:
        cap = 2 * INTERNAL_K
        nodes = [list(range(i, min(i + cap, width))) for i in range(0, width, cap)] or [[]]
        levels.append(nodes)
        if len(nodes) == 1:
            return levels
        width = len(nodes)


def _check_name(path: str, name) -> None:
    if not isinstance(name, str) or not name or "/" in name or "\0" in name or name == ".":
        raise ValueError(f"{path}: dataset name {name!r} (a plain name in the root group)")


def _layout(specs: List[Tuple[bytes, Tuple[int, ...], np.dtype]]) -> Tuple[bytes, List[int]]:
    """The file's metadata for datasets ``(name, shape, dtype)`` sorted by
    name, and each one's data address (UNDEF for an empty one); the data
    follow the metadata, each 8-aligned, the last ending the file."""
    # the local heap: the empty name at offset 0, then each name, 8-aligned
    heap, name_off = bytearray(8), []
    for name, _, _ in specs:
        name_off.append(len(heap))
        heap += name + b"\0" * (_pad8(len(name) + 1) - len(name))

    snods = [list(range(i, min(i + 2 * LEAF_K, len(specs))))
             for i in range(0, len(specs), 2 * LEAF_K)]
    levels = _tree_levels(len(snods))
    root_header = 96
    addr = root_header + 16 + 24
    tree_addr = []
    for nodes in levels:
        tree_addr.append([addr + TREE_SIZE * i for i in range(len(nodes))])
        addr += TREE_SIZE * len(nodes)
    heap_addr = addr
    addr += HEAP_HEADER + len(heap)
    snod_addr = [addr + SNOD_SIZE * i for i in range(len(snods))]
    addr += SNOD_SIZE * len(snods)
    nbytes = [math.prod(shape) * dtype.itemsize for _, shape, dtype in specs]
    headers = [_dataset_header(shape, dtype, 0, 0) for _, shape, dtype in specs]
    header_addr = []
    for h in headers:
        header_addr.append(addr)
        addr += len(h)
    data_addr = []
    for size in nbytes:
        if not size:
            data_addr.append(UNDEF)
            continue
        addr = _pad8(addr)
        data_addr.append(addr)
        addr += size
    eof = addr

    out = bytearray(SUPERBLOCK_SIZE)
    root_tree = tree_addr[-1][0]
    struct.pack_into("<8sBBBBBBBBHHI4Q", out, 0, SIGNATURE, 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K,
                     INTERNAL_K, 0, 0, UNDEF, eof, UNDEF)
    struct.pack_into("<QQI4xQQ", out, 56, 0, root_header, 1, root_tree, heap_addr)
    out += struct.pack("<BxHII4x", 1, 1, 1, 24) + _message(
        SYMBOL_TABLE, 0, struct.pack("<QQ", root_tree, heap_addr))

    # the largest name under each node (its heap offset), level by level
    last = [name_off[s[-1]] for s in snods]
    for lvl, nodes in enumerate(levels):
        below = last
        for i, children in enumerate(nodes):
            left = tree_addr[lvl][i - 1] if i > 0 else UNDEF
            right = tree_addr[lvl][i + 1] if i + 1 < len(nodes) else UNDEF
            node = bytearray(TREE_SIZE)
            struct.pack_into("<4sBBHQQ", node, 0, b"TREE", 0, lvl, len(children), left, right)
            key0 = below[children[0] - 1] if children and children[0] > 0 else 0
            struct.pack_into("<Q", node, 24, key0)
            child_addr = snod_addr if lvl == 0 else tree_addr[lvl - 1]
            for j, c in enumerate(children):
                struct.pack_into("<QQ", node, 32 + 16 * j, child_addr[c], below[c])
            out += node
        last = [below[c[-1]] for c in nodes if c]

    out += struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap), FREE_NULL,
                       heap_addr + HEAP_HEADER) + heap
    for s in snods:
        node = bytearray(SNOD_SIZE)
        struct.pack_into("<4sBxH", node, 0, b"SNOD", 1, len(s))
        for j, k in enumerate(s):
            struct.pack_into("<QQI", node, 8 + j * ENTRY_SIZE, name_off[k], header_addr[k], 0)
        out += node
    for (_, shape, dtype), d, size in zip(specs, data_addr, nbytes):
        out += _dataset_header(shape, dtype, d, size)
    return bytes(out), data_addr



def _specs(path: str, shapes: Mapping[str, Tuple[Tuple[int, ...], np.dtype]]):
    specs = []
    for name, (shape, dtype) in shapes.items():
        _check_name(path, name)
        dtype = np.dtype(dtype).newbyteorder("<")
        _type_message(dtype)
        specs.append((name.encode(), tuple(int(d) for d in shape), dtype))
    return sorted(specs, key=lambda it: it[0])


def write_h5(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    """Write ``arrays`` as datasets of the root group of a new HDF5 file at
    ``path`` (h5py's default layout: superblock 0, a symbol-table root
    group, contiguous storage), published atomically."""
    arrays = {name: np.asarray(arr) for name, arr in arrays.items()}
    specs = _specs(path, {name: (a.shape, a.dtype) for name, a in arrays.items()})
    meta, data_addr = _layout(specs)
    with atomic_path(path) as tmp, open(tmp, "wb") as f:
        f.write(meta)
        pos = len(meta)
        for (name, _, dtype), d in zip(specs, data_addr):
            if d == UNDEF:
                continue
            # little-endian, C order; astype keeps a 0-d array's shape
            a = arrays[name.decode()].astype(dtype, order="C", copy=False)
            f.write(b"\0" * (d - pos))
            f.write(memoryview(a.reshape(-1)).cast("B"))
            pos = d + a.nbytes


class H5Writer:
    """A new HDF5 file (:func:`write_h5`'s layout) of datasets of known
    shape and type, filled block by block along their first axis, so a
    table need never be held whole (``cli/extract`` writes its feature
    tables so). ``with H5Writer(path, {"features": ((n, 4096), "f4")}) as
    w: w.write("features", row0, block)``; rows never written read as
    zeros. Published atomically on a clean exit; nothing is published if
    the block raises."""

    def __init__(self, path: str, shapes: Mapping[str, Tuple[Tuple[int, ...], np.dtype]]):
        self.path = path
        specs = _specs(path, shapes)
        meta, data_addr = _layout(specs)
        self._meta = meta
        self._eof = max([d + math.prod(s) * t.itemsize for (_, s, t), d in zip(specs, data_addr)
                         if d != UNDEF] + [len(meta)])
        self._datasets = {name.decode(): (shape, dtype, d)
                          for (name, shape, dtype), d in zip(specs, data_addr)}
        self._stack = None
        self._file = None

    def __enter__(self) -> "H5Writer":
        import contextlib

        self._stack = contextlib.ExitStack()
        tmp = self._stack.enter_context(atomic_path(self.path))
        self._file = self._stack.enter_context(open(tmp, "wb"))
        self._file.write(self._meta)
        self._file.truncate(self._eof)
        return self

    def write(self, name: str, row0: int, block) -> None:
        """Rows ``row0 ..`` of dataset ``name`` from ``block`` (cast to the
        dataset's type)."""
        shape, dtype, addr = self._datasets[name]
        block = np.asarray(block).astype(dtype, order="C", copy=False)
        rows = block.shape[0] if block.ndim else 0
        if block.shape[1:] != shape[1:] or row0 < 0 or row0 + rows > shape[0]:
            raise ValueError(f"{self.path}: rows [{row0}, {row0 + rows}) of shape "
                             f"{block.shape[1:]} do not fit dataset {name!r} of shape {shape}")
        if not block.size:
            return
        self._file.seek(addr + row0 * math.prod(shape[1:]) * dtype.itemsize)
        self._file.write(memoryview(block.reshape(-1)).cast("B"))

    def __exit__(self, *exc) -> bool:
        stack, self._stack, self._file = self._stack, None, None
        return stack.__exit__(*exc)
