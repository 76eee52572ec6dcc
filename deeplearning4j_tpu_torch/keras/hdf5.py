"""HDF5 archive reader and writer in plain Python (the JAX package's
``keras/hdf5.py``, which binds libhdf5 through a native shim).

Ref: deeplearning4j-modelimport/.../keras/Hdf5Archive.java:22-51. The
surface is the JAX package's: ``read_attribute_as_string``,
``read_attribute_as_string_list``, ``list_children`` (``('g'|'d'|'?',
name)`` in name order), ``read_dataset`` (float32, converted as
``H5Dread`` to ``H5T_NATIVE_FLOAT`` converts), ``create`` and the
context managers; ``Hdf5Archive`` also takes the file's ``bytes`` (a
``.keras`` zip's ``model.weights.h5``).

The port needs no libhdf5 and no h5py: the format is parsed over
``struct`` and numpy. The reader covers what libhdf5 writes by default
and Keras files hold:

- superblock version 0 or 1 (after an optional user block);
- version-1 object headers and their continuation blocks;
- symbol-table groups: version-1 B-trees of type 0 at any depth, their
  local heap and symbol-table nodes;
- contiguous and compact datasets (data layout message version 3) of
  little-endian integers (1, 2, 4, 8 bytes) and IEEE floats (4, 8);
- attributes that are scalars or 1-D arrays of fixed-length strings, or
  of variable-length strings held in global-heap collections (an empty
  numeric array reads as an empty list, as libhdf5's reader gives it).

Anything else raises ``Hdf5Unsupported`` naming what it met (chunked or
filtered storage, version-2 object headers, a version-2/3 superblock,
dense attribute storage, new-style groups, shared messages), so an
unsupported file never reads as a wrong answer.

``Hdf5Writer`` writes the layout libhdf5 writes by default: superblock
version 0, version-1 object headers, symbol-table groups of any size (a
B-tree over symbol-table nodes of up to 8 entries, 32 children a node,
as many levels as the group needs), fixed-length string attributes as
``native/hdf5_reader.cc``'s ``h5w_write_attr_str`` /
``h5w_write_attr_strlist`` write them (NUL-terminated type as wide as the
string, or the longest string of the list), and contiguous float32
datasets. The file is laid out when it is closed.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_MSG_DATASPACE, _MSG_LINK_INFO, _MSG_DATATYPE = 0x1, 0x2, 0x3
_MSG_LINK, _MSG_LAYOUT, _MSG_FILTERS, _MSG_ATTRIBUTE = 0x6, 0x8, 0xB, 0xC
_MSG_CONTINUATION, _MSG_SYMBOL_TABLE, _MSG_ATTR_INFO = 0x10, 0x11, 0x15

# the writer's group B-tree shape: libhdf5's defaults (leaf K 4, internal
# K 16), so a symbol-table node holds up to 8 entries and a B-tree node
# up to 32 children
_LEAF_K, _INTERNAL_K = 4, 16
_STE_SIZE = 40   # a symbol-table entry with 8-byte offsets and lengths


class Hdf5Unsupported(IOError):
    """The file uses a part of HDF5 outside the reader's subset."""


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _pad8(b: bytes) -> bytes:
    """``b`` NUL-padded to a multiple of 8 bytes."""
    return b + b"\0" * (_align8(len(b)) - len(b))


class _Datatype:
    """A parsed datatype message: ``cls`` (0 integer, 1 float, 3 string,
    9 variable-length), element ``size``, and for strings the padding
    (0 NUL-terminated, 1 NUL-padded, 2 space-padded); for variable-length
    types whether it is a string."""

    __slots__ = ("cls", "size", "dtype", "pad", "vlen_string")

    def __init__(self, cls, size, dtype=None, pad=0, vlen_string=False):
        self.cls, self.size, self.dtype = cls, size, dtype
        self.pad, self.vlen_string = pad, vlen_string


class Hdf5Archive:
    """Read-only view of one HDF5 file, from a path or from its bytes."""

    def __init__(self, source: Union[str, Path, bytes, bytearray]):
        if isinstance(source, (bytes, bytearray, memoryview)):
            self._buf, self._name = bytes(source), "<bytes>"
        else:
            try:
                self._buf = Path(source).read_bytes()
            except OSError as e:
                raise FileNotFoundError(
                    f"Cannot open HDF5 file {str(source)!r}") from e
            self._name = str(source)
        self._headers: Dict[int, list] = {}
        self._groups: Dict[int, List[Tuple[str, int]]] = {}
        self._gcols: Dict[int, Dict[int, bytes]] = {}
        self._parse_superblock()

    def close(self):
        self._buf = b""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # ------------------------------------------------------------ low level
    def _unsupported(self, what: str):
        raise Hdf5Unsupported(
            f"{self._name}: {what} is outside this HDF5 reader's subset "
            "(superblock v0/v1, v1 object headers, symbol-table groups, "
            "contiguous or compact datasets)")

    def _u(self, off: int, size: int) -> int:
        if off < 0 or off + size > len(self._buf):
            raise IOError(f"{self._name}: read past the end of the file "
                          f"at {off}")
        return int.from_bytes(self._buf[off:off + size], "little")

    def _addr(self, off: int) -> int:
        a = self._u(off, self._so)
        return UNDEF if a == (1 << (8 * self._so)) - 1 else a + self._base

    def _sig(self, off: int, sig: bytes, what: str):
        if self._buf[off:off + 4] != sig:
            raise IOError(f"{self._name}: no {what} at {off} (corrupt or "
                          "not an HDF5 file)")

    def _parse_superblock(self):
        off = 0
        while off + 8 <= len(self._buf):
            if self._buf[off:off + 8] == SIGNATURE:
                break
            off = 512 if off == 0 else off * 2
        else:
            raise IOError(f"{self._name}: not an HDF5 file (no signature)")
        version = self._buf[off + 8]
        if version not in (0, 1):
            self._unsupported(f"superblock version {version} "
                              "(a file written with libver='latest')")
        self._so, self._sl = self._buf[off + 13], self._buf[off + 14]
        if self._so != 8 or self._sl != 8:
            self._unsupported(f"{self._so}-byte offsets / {self._sl}-byte "
                              "lengths")
        p = off + 24 + (4 if version == 1 else 0)
        self._base = 0
        self._base = self._addr(p)
        ste = p + 4 * self._so
        self._root = self._addr(ste + self._so)

    # --------------------------------------------------------- object headers
    def _messages(self, addr: int) -> list:
        """[(type, data offset, size)] of the version-1 object header at
        ``addr``, continuation blocks followed."""
        if addr in self._headers:
            return self._headers[addr]
        if self._buf[addr:addr + 4] == b"OHDR":
            self._unsupported("a version-2 object header")
        version = self._buf[addr]
        if version != 1:
            self._unsupported(f"object header version {version}")
        n_msgs = self._u(addr + 2, 2)
        blocks = [(addr + 16, self._u(addr + 8, 4))]
        out = []
        while blocks and len(out) < n_msgs:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end and len(out) < n_msgs:
                mtype, msize = self._u(p, 2), self._u(p + 2, 2)
                flags = self._buf[p + 4]
                data = p + 8
                if flags & 0x02:
                    self._unsupported(f"a shared message (type {mtype:#x})")
                if mtype == _MSG_CONTINUATION:
                    blocks.append((self._addr(data),
                                   self._u(data + self._so, self._sl)))
                out.append((mtype, data, msize))
                p = data + msize
        self._headers[addr] = out
        return out

    def _find(self, msgs, mtype):
        return [(off, size) for t, off, size in msgs if t == mtype]

    def _kind(self, addr: int) -> str:
        types = {t for t, _, _ in self._messages(addr)}
        if types & {_MSG_SYMBOL_TABLE, _MSG_LINK_INFO, _MSG_LINK}:
            return "g"
        if _MSG_LAYOUT in types:
            return "d"
        return "?"

    # ----------------------------------------------------------------- groups
    def _heap_string(self, data_addr: int, offset: int) -> str:
        start = data_addr + offset
        end = self._buf.index(b"\0", start)
        return self._buf[start:end].decode("utf-8", "replace")

    def _children(self, addr: int) -> List[Tuple[str, int]]:
        """[(name, object header address)] of the group at ``addr``, in
        the B-tree's (name) order."""
        if addr in self._groups:
            return self._groups[addr]
        msgs = self._messages(addr)
        if self._find(msgs, _MSG_LINK_INFO) or self._find(msgs, _MSG_LINK):
            self._unsupported("a new-style group (link messages)")
        stab = self._find(msgs, _MSG_SYMBOL_TABLE)
        if not stab:
            raise IOError(f"{self._name}: object at {addr} is not a group")
        off = stab[0][0]
        btree, heap = self._addr(off), self._addr(off + self._so)
        self._sig(heap, b"HEAP", "local heap")
        heap_data = self._addr(heap + 8 + 2 * self._sl)
        out: List[Tuple[str, int]] = []
        self._walk_btree(btree, heap_data, out)
        self._groups[addr] = out
        return out

    def _walk_btree(self, node: int, heap_data: int, out: list):
        self._sig(node, b"TREE", "B-tree node")
        if self._buf[node + 4] != 0:
            self._unsupported(f"a B-tree of type {self._buf[node + 4]} "
                              "where a group's (type 0) belongs")
        level, used = self._buf[node + 5], self._u(node + 6, 2)
        p = node + 8 + 2 * self._so + self._sl      # past key 0
        for _ in range(used):
            child = self._addr(p)
            if level > 0:
                self._walk_btree(child, heap_data, out)
            else:
                self._read_snod(child, heap_data, out)
            p += self._so + self._sl
        return out

    def _read_snod(self, node: int, heap_data: int, out: list):
        self._sig(node, b"SNOD", "symbol-table node")
        n = self._u(node + 6, 2)
        p = node + 8
        for _ in range(n):
            name = self._heap_string(heap_data, self._u(p, self._so))
            out.append((name, self._addr(p + self._so)))
            p += 2 * self._so + 24

    def _lookup(self, path: str) -> Optional[int]:
        """The object header address at ``path``, or None."""
        addr = self._root
        for part in (s for s in path.split("/") if s and s != "."):
            if self._kind(addr) != "g":
                return None
            match = [a for n, a in self._children(addr) if n == part]
            if not match:
                return None
            addr = match[0]
        return addr

    def _object(self, path: str) -> int:
        addr = self._lookup(path)
        if addr is None:
            raise IOError(f"{self._name}: no object at {path!r}")
        return addr

    # -------------------------------------------------------- types / spaces
    def _datatype(self, off: int) -> _Datatype:
        cls, version = self._buf[off] & 0x0F, self._buf[off] >> 4
        bits = self._u(off + 1, 3)
        size = self._u(off + 4, 4)
        if cls in (0, 1):
            if bits & 0x01:
                self._unsupported("a big-endian number")
            if cls == 0:
                if size not in (1, 2, 4, 8):
                    self._unsupported(f"a {size}-byte integer")
                kind = "i" if bits & 0x08 else "u"
            else:
                if size not in (4, 8):
                    self._unsupported(f"a {size}-byte float")
                kind = "f"
            precision = self._u(off + 10, 2)
            if self._u(off + 8, 2) != 0 or precision != 8 * size:
                self._unsupported("a number with padding bits")
            return _Datatype(cls, size, np.dtype(f"<{kind}{size}"))
        if cls == 3:
            return _Datatype(cls, size, pad=bits & 0x0F)
        if cls == 9:
            if bits & 0x0F != 1:
                self._unsupported("a variable-length sequence")
            return _Datatype(cls, 4 + self._so + 4, vlen_string=True)
        names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 10: "array"}
        self._unsupported(f"the {names.get(cls, cls)} datatype "
                          f"(class {cls}, version {version})")

    def _dataspace(self, off: int) -> Tuple[int, ...]:
        """The current dims (any maximum dims after them are not read)."""
        version, rank = self._buf[off], self._buf[off + 1]
        if version == 1:
            p = off + 8
        elif version == 2:
            if self._buf[off + 3] == 2:     # null dataspace
                return (0,)
            p = off + 4
        else:
            self._unsupported(f"dataspace version {version}")
        return tuple(self._u(p + i * self._sl, self._sl)
                     for i in range(rank))

    # ------------------------------------------------------------ attributes
    def _attribute(self, obj_path: str, attr: str):
        """(datatype, shape, data offset) of ``attr`` on ``obj_path``, or
        None when the object or the attribute does not exist."""
        addr = self._lookup(obj_path)
        if addr is None:
            return None
        msgs = self._messages(addr)
        for off, _ in self._find(msgs, _MSG_ATTR_INFO):
            flags = self._buf[off + 1]
            p = off + 2 + (2 if flags & 0x01 else 0)
            if self._addr(p) != UNDEF:
                self._unsupported("dense attribute storage")
        for off, _ in self._find(msgs, _MSG_ATTRIBUTE):
            version, flags = self._buf[off], self._buf[off + 1]
            if version not in (1, 2, 3):
                self._unsupported(f"attribute message version {version}")
            if flags & 0x03:
                self._unsupported("a shared attribute datatype/dataspace")
            name_len = self._u(off + 2, 2)
            dt_len, ds_len = self._u(off + 4, 2), self._u(off + 6, 2)
            p = off + 8 + (1 if version == 3 else 0)
            pad = _align8 if version == 1 else (lambda n: n)
            name = self._buf[p:p + name_len].split(b"\0")[0].decode(
                "utf-8", "replace")
            p += pad(name_len)
            if name != attr:
                continue
            dtype = self._datatype(p)
            p += pad(dt_len)
            shape = self._dataspace(p)
            p += pad(ds_len)
            return dtype, shape, p
        return None

    def _global_heap_object(self, collection: int, index: int) -> bytes:
        objs = self._gcols.get(collection)
        if objs is None:
            self._sig(collection, b"GCOL", "global heap collection")
            end = collection + self._u(collection + 8, self._sl)
            objs, p = {}, collection + 8 + self._sl
            while p + 8 + self._sl <= end:
                idx = self._u(p, 2)
                if idx == 0:          # the free space that ends it
                    break
                size = self._u(p + 8, self._sl)
                data = p + 8 + self._sl
                objs[idx] = self._buf[data:data + size]
                p = data + _align8(size)
            self._gcols[collection] = objs
        if index not in objs:
            raise IOError(f"{self._name}: global heap object {index} missing "
                          f"from the collection at {collection}")
        return objs[index]

    def _strings(self, dtype: _Datatype, shape, p) -> List[Optional[str]]:
        """The string elements of an attribute (None for a null
        variable-length element)."""
        n = int(np.prod(shape)) if shape else 1
        out: List[Optional[str]] = []
        for i in range(n):
            e = p + i * dtype.size
            if dtype.vlen_string:
                length = self._u(e, 4)
                coll = self._addr(e + 4)
                if coll == UNDEF or coll == 0:
                    out.append(None)
                    continue
                raw = self._global_heap_object(coll, self._u(e + 4 + self._so,
                                                             4))[:length]
            else:
                raw = self._buf[e:e + dtype.size]
                if dtype.pad == 2:
                    raw = raw.rstrip(b" ")
            out.append(raw.split(b"\0")[0].decode("utf-8", "replace"))
        return out

    def read_attribute_as_string(self, attr: str,
                                 obj_path: str = "/") -> Optional[str]:
        """A string attribute (its first element if it is an array), or
        None when it is missing (ref: Hdf5Archive.readAttributeAsString)."""
        found = self._attribute(obj_path, attr)
        if found is None:
            return None
        dtype, shape, p = found
        if dtype.cls not in (3, 9):
            raise IOError(f"Failed reading attribute {attr!r} at "
                          f"{obj_path!r}: not a string")
        strings = self._strings(dtype, shape, p)
        return (strings[0] or "") if strings else ""

    def read_attribute_as_string_list(self, attr: str, obj_path: str = "/"
                                      ) -> Optional[List[str]]:
        """A 1-D (or scalar) string attribute as a list, or None when it
        is missing; an empty array of any type is []. Elements are joined
        with newlines and split again, as the libhdf5 reader's buffer
        carries them: an empty list, or a lone empty string, reads as []."""
        found = self._attribute(obj_path, attr)
        if found is None:
            return None
        dtype, shape, p = found
        if shape and int(np.prod(shape)) == 0:
            return []
        if dtype.cls not in (3, 9):
            raise IOError(f"Failed reading attribute {attr!r} at "
                          f"{obj_path!r}: not a string list")
        strings = self._strings(dtype, shape, p)
        if dtype.vlen_string:      # null elements skipped, as libhdf5's
            joined = ""
            for s in strings:
                if s is not None:
                    joined = f"{joined}\n{s}" if joined else s
        else:
            joined = "\n".join(strings)
        return joined.split("\n") if joined else []

    # ---------------------------------------------------------------- listing
    def list_children(self, path: str = "/") -> List[Tuple[str, str]]:
        """[(kind 'g'|'d'|'?', name)] in name order; [] when ``path`` is
        not a group (ref: Hdf5Archive.getDataSets/getGroups)."""
        addr = self._lookup(path)
        if addr is None or self._kind(addr) != "g":
            return []
        return [(self._kind(a), n) for n, a in self._children(addr)]

    # --------------------------------------------------------------- datasets
    def read_dataset(self, path: str) -> np.ndarray:
        """The dataset at ``path`` as float32
        (ref: Hdf5Archive.readDataSet)."""
        addr = self._lookup(path)
        if addr is None or self._kind(addr) != "d":
            raise IOError(f"Cannot read dataset {path!r}")
        msgs = self._messages(addr)
        dtype = self._datatype(self._find(msgs, _MSG_DATATYPE)[0][0])
        shape = self._dataspace(self._find(msgs, _MSG_DATASPACE)[0][0])
        if dtype.dtype is None:
            raise IOError(f"Failed reading dataset {path!r}: not numeric")
        lay = self._find(msgs, _MSG_LAYOUT)[0][0]
        version, cls = self._buf[lay], self._buf[lay + 1]
        filters = self._find(msgs, _MSG_FILTERS)
        if version != 3:
            self._unsupported(f"data layout message version {version}")
        if cls == 2 or filters:
            self._unsupported("chunked storage" + (
                " with a filter pipeline (compression)" if filters else ""))
        n = int(np.prod(shape)) if shape else 1
        nbytes = n * dtype.size
        if cls == 0:                       # compact: the data in the header
            size = self._u(lay + 2, 2)
            start = lay + 4
        elif cls == 1:
            start = self._addr(lay + 2)
            size = self._u(lay + 2 + self._so, self._sl)
            if start == UNDEF:             # never written: the fill value
                return np.zeros(shape, np.float32)
        else:
            self._unsupported(f"data layout class {cls}")
        if size < nbytes or start + nbytes > len(self._buf):
            raise IOError(f"Failed reading dataset {path!r}: storage holds "
                          f"{size} bytes of {nbytes}")
        raw = np.frombuffer(self._buf, dtype.dtype, n, start)
        return raw.astype(np.float32).reshape(shape)

    # ---------------------------------------------------------------- writing
    @staticmethod
    def create(path: str) -> "Hdf5Writer":
        return Hdf5Writer(path)


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("children", "attrs", "data")

    def __init__(self, data=None):
        self.children: Dict[str, "_Node"] = {}
        self.attrs: List[Tuple[str, bytes, bytes, bytes]] = []
        self.data = data      # None for a group


def _msg(mtype: int, body: bytes) -> bytes:
    body = _pad8(body)
    if len(body) > 0xFFFF:
        raise IOError(f"an object header message of {len(body)} bytes does "
                      "not fit a version-1 object header")
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _dataspace_msg(shape) -> bytes:
    return (struct.pack("<BBB5x", 1, len(shape), 0)
            + b"".join(struct.pack("<Q", d) for d in shape))


def _string_type(size: int) -> bytes:
    # class 3 (string), version 1, NUL-terminated, ASCII
    return struct.pack("<B3sI", 0x13, b"\0\0\0", size)


_FLOAT32_TYPE = (struct.pack("<B3sI", 0x11, bytes([0x20, 31, 0]), 4)
                 + struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127))


def _attr_msg(name: str, dtype: bytes, space: bytes, data: bytes) -> bytes:
    nm = name.encode() + b"\0"
    return _msg(_MSG_ATTRIBUTE,
                struct.pack("<BBHHH", 1, 0, len(nm), len(dtype), len(space))
                + _pad8(nm) + _pad8(dtype) + _pad8(space) + data)


class Hdf5Writer:
    """Write-side companion (fixtures and Keras-format export): the JAX
    writer's surface; groups, attributes and datasets are kept in memory
    and laid out on ``close``."""

    def __init__(self, path: str):
        self._path = str(path)
        try:
            Path(self._path).write_bytes(b"")
        except OSError as e:
            raise IOError(f"Cannot create HDF5 file {self._path!r}") from e
        self._root: Optional[_Node] = _Node()

    def _node(self, path: str, what: str) -> _Node:
        node = self._root
        for part in (s for s in path.split("/") if s):
            if node.data is not None or part not in node.children:
                raise IOError(f"Cannot {what}: no group {path!r}")
            node = node.children[part]
        return node

    def _new(self, path: str, node: _Node, what: str):
        parent, _, name = path.rstrip("/").rpartition("/")
        group = self._node(parent, what)
        if not name or group.data is not None or name in group.children:
            raise IOError(f"Cannot {what} {path!r}")
        group.children[name] = node

    def create_group(self, path: str):
        self._new(path, _Node(), "create group")

    def write_attr_str(self, obj_path: str, attr: str, value: str):
        raw = value.encode()
        self._node(obj_path, f"write attr {attr!r}").attrs.append(
            (attr, _string_type(max(len(raw), 1)), _dataspace_msg(()),
             raw or b"\0"))

    def write_attr_strlist(self, obj_path: str, attr: str, values: List[str]):
        items = [v.encode() for v in "\n".join(values).split("\n")]
        width = max([1] + [len(v) for v in items])
        self._node(obj_path, f"write attr {attr!r}").attrs.append(
            (attr, _string_type(width), _dataspace_msg((len(items),)),
             b"".join(v.ljust(width, b"\0") for v in items)))

    def write_dataset(self, path: str, data: np.ndarray):
        data = np.ascontiguousarray(data, dtype="<f4")
        self._new(path, _Node(data), "create dataset")

    def close(self):
        top, self._root = self._root, None
        if top is None:
            return
        buf = bytearray(96)                 # the superblock, patched last

        def put(b: bytes) -> int:
            buf.extend(b"\0" * (_align8(len(buf)) - len(buf)))
            off = len(buf)
            buf.extend(b)
            return off

        def header(msgs: List[bytes]) -> int:
            body = b"".join(msgs)
            return put(struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body))
                       + body)

        def attrs(node: _Node) -> List[bytes]:
            return [_attr_msg(*a) for a in node.attrs]

        def write(node: _Node) -> Tuple[int, Optional[Tuple[int, int]]]:
            """(object header address, (B-tree, heap) for a group)."""
            if node.data is not None:
                d = node.data
                raw = put(d.tobytes()) if d.size else UNDEF
                layout = struct.pack("<BBQQ", 3, 1, raw, d.nbytes)
                return header([_msg(_MSG_DATASPACE, _dataspace_msg(d.shape)),
                               _msg(_MSG_DATATYPE, _FLOAT32_TYPE),
                               _msg(_MSG_LAYOUT, layout)]
                              + attrs(node)), None
            names = sorted(node.children, key=lambda s: s.encode())
            entries = [(n,) + write(node.children[n]) for n in names]
            # the local heap: "" at 0, then each name NUL-terminated,
            # padded to 8 bytes
            heap, offsets = bytearray(8), {}
            for n in names:
                offsets[n] = len(heap)
                heap.extend(_pad8(n.encode() + b"\0"))
            heap_data = put(bytes(heap))
            heap_addr = put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap),
                                                  1, heap_data))
            # symbol-table nodes of up to 2 * leaf K entries
            level: List[Tuple[int, str]] = []    # (child address, max name)
            cap = 2 * _LEAF_K
            for i in range(0, len(entries), cap):
                chunk = entries[i:i + cap]
                body = bytearray(b"SNOD" + struct.pack("<BBH", 1, 0,
                                                       len(chunk)))
                for n, addr, stab in chunk:
                    cache, scratch = (1, struct.pack("<QQ", *stab)) \
                        if stab else (0, b"\0" * 16)
                    body += struct.pack("<QQI4x", offsets[n], addr, cache)
                    body += scratch
                body += b"\0" * (8 + cap * _STE_SIZE - len(body))
                level.append((put(bytes(body)), chunk[-1][0]))
            # B-tree nodes of up to 2 * internal K children, level by level
            cap, depth = 2 * _INTERNAL_K, 0
            node_size = 24 + (2 * cap + 1) * 8
            while True:
                groups = [level[i:i + cap]
                          for i in range(0, len(level), cap)] or [[]]
                nxt = []
                for g in groups:
                    body = bytearray(b"TREE" + struct.pack(
                        "<BBHQQ", 0, depth, len(g), UNDEF, UNDEF))
                    body += struct.pack("<Q", 0)           # key 0: ""
                    for child, last in g:
                        body += struct.pack("<QQ", child, offsets[last])
                    body += b"\0" * (node_size - len(body))
                    nxt.append((put(bytes(body)), g[-1][1] if g else ""))
                if len(nxt) == 1:
                    btree = nxt[0][0]
                    break
                level, depth = nxt, depth + 1
            stab = (btree, heap_addr)
            return header([_msg(_MSG_SYMBOL_TABLE, struct.pack("<QQ", *stab))]
                          + attrs(node)), stab

        root, (btree, heap) = write(top)
        buf[0:96] = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                     + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
                     + struct.pack("<QQQQ", 0, UNDEF, len(buf), UNDEF)
                     + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
        Path(self._path).write_bytes(bytes(buf))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
