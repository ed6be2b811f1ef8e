"""Pure-Python LMDB environment, read path and a minimal writer (the port's
copy of lfm_tpu/data/minilmdb.py).

The reference reads NVAE/LSUN/torchtoolbox datasets through the `lmdb` C
binding (reference datasets_prep/lmdb_datasets.py:11, lsun.py:26-67). The
port does not depend on that binding (the card's machine has none); data
loading is host-side anyway, so this module implements the on-disk LMDB
format directly:

  * ``open()`` -> ``Env`` with the API subset the datasets use:
    ``begin()`` transactions, ``txn.get(key)``, ``txn.stat()``,
    ``txn.cursor().iternext(keys, values)``;
  * ``write_db(path, items)`` -> a minimal valid single-writer database
    (meta pages + sorted leaf/branch B+tree + overflow pages) used by the
    dataset-preparation tools and test fixtures.

Format per the published LMDB file layout (lmdb.tech; struct layout of
MDB_page/MDB_node/MDB_meta/MDB_db from the liblmdb headers): 4096-byte
pages; pages 0/1 are meta (magic 0xBEEFC0DE, pick the larger txnid); the
main DB root is a B+tree of branch/leaf pages; node pointers are little-
endian u16 offsets; values larger than the in-page maximum live on
P_OVERFLOW page runs referenced by F_BIGDATA nodes. The reader is held
against databases written by this writer and by the JAX package's, and
against a database no writer of the repository made: a byte-by-byte hand
assembly from the liblmdb header layout (tools/make_lmdb_fixture.py,
committed at tests/fixtures/lmdb_handmade/) with scrambled physical node
order, a stale second meta page and an overflow run
(tests/test_torch_data.py).
"""

from __future__ import annotations

import builtins
import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

PAGE_SIZE = 4096
MAGIC = 0xBEEFC0DE
VERSION = 1

# MDB_page.mp_flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# MDB_node.mn_flags
F_BIGDATA = 0x01

_PAGE_HDR = struct.Struct("<QHHHH")  # pgno, pad, flags, pb_lower, pb_upper
_META = struct.Struct("<IIQQ")       # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")     # pad, flags, depth, branch, leaf, ovf, entries, root
_NODE_HDR = struct.Struct("<HHHH")   # lo, hi, flags, ksize
_PGNO = struct.Struct("<Q")

_HDR_SIZE = 16  # offsetof(MDB_page, mp_ptrs)


class Cursor:
    def __init__(self, txn: "Txn"):
        self._txn = txn

    def iternext(self, keys: bool = True, values: bool = True) -> Iterator:
        for k, v in self._txn._env._iter_items():
            if keys and values:
                yield k, v
            elif keys:
                yield k
            else:
                yield v


class Txn:
    def __init__(self, env: "Env"):
        self._env = env

    def get(self, key: bytes):
        return self._env._get(bytes(key))

    def stat(self) -> Dict:
        db = self._env._main_db
        return {
            "psize": PAGE_SIZE, "depth": db["depth"],
            "branch_pages": db["branch_pages"], "leaf_pages": db["leaf_pages"],
            "overflow_pages": db["overflow_pages"], "entries": db["entries"],
        }

    def cursor(self) -> Cursor:
        return Cursor(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Env:
    """Read-only LMDB environment over a memory-mapped data file."""

    def __init__(self, path: str):
        data = path if path.endswith(".mdb") else os.path.join(path, "data.mdb")
        if not os.path.exists(data) and os.path.isfile(path):
            data = path
        import mmap

        self._f = builtins.open(data, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._main_db = self._read_meta()

    # -- format ------------------------------------------------------------
    def _page(self, pgno: int) -> memoryview:
        off = pgno * PAGE_SIZE
        return memoryview(self._mm)[off:]

    def _read_meta(self) -> Dict:
        best = None
        for pgno in (0, 1):
            p = self._page(pgno)
            _, _, flags, _, _ = _PAGE_HDR.unpack_from(p, 0)
            magic, version, _, _ = _META.unpack_from(p, _HDR_SIZE)
            if not (flags & P_META) or magic != MAGIC:
                continue
            meta_off = _HDR_SIZE + _META.size
            dbs = []
            for i in range(2):
                vals = _DB.unpack_from(p, meta_off + i * _DB.size)
                dbs.append(dict(zip(
                    ("pad", "flags", "depth", "branch_pages", "leaf_pages",
                     "overflow_pages", "entries", "root"), vals)))
            txnid = _PGNO.unpack_from(p, meta_off + 2 * _DB.size + 8)[0]
            if best is None or txnid >= best[0]:
                best = (txnid, dbs[1])  # mm_dbs[1] == main DB
        if best is None:
            raise ValueError("not an LMDB data file (no valid meta page)")
        return best[1]

    def _node_count(self, p: memoryview) -> int:
        _, _, _, lower, _ = _PAGE_HDR.unpack_from(p, 0)
        return (lower - _HDR_SIZE) // 2

    def _node_offsets(self, p: memoryview) -> List[int]:
        n = self._node_count(p)
        return list(struct.unpack_from(f"<{n}H", p, _HDR_SIZE)) if n else []

    def _leaf_item(self, p: memoryview, off: int) -> Tuple[bytes, bytes]:
        lo, hi, flags, ksize = _NODE_HDR.unpack_from(p, off)
        dsize = lo | (hi << 16)
        key = bytes(p[off + 8: off + 8 + ksize])
        if flags & F_BIGDATA:
            ovf_pgno = _PGNO.unpack_from(p, off + 8 + ksize)[0]
            return key, self._read_overflow(ovf_pgno, dsize)
        data = bytes(p[off + 8 + ksize: off + 8 + ksize + dsize])
        return key, data

    def _branch_item(self, p: memoryview, off: int) -> Tuple[bytes, int]:
        lo, hi, flags, ksize = _NODE_HDR.unpack_from(p, off)
        pgno = lo | (hi << 16) | (flags << 32)  # 48-bit pgno (mdb.c NODEPGNO)
        key = bytes(p[off + 8: off + 8 + ksize])
        return key, pgno

    def _read_overflow(self, pgno: int, size: int) -> bytes:
        p = self._page(pgno)
        _, _, flags, _, _ = _PAGE_HDR.unpack_from(p, 0)
        assert flags & P_OVERFLOW, f"page {pgno} is not an overflow page"
        return bytes(p[_HDR_SIZE:_HDR_SIZE + size])

    # -- lookups -----------------------------------------------------------
    def _get(self, key: bytes) -> Optional[bytes]:
        db = self._main_db
        pgno = db["root"]
        if pgno == 0xFFFFFFFFFFFFFFFF:  # P_INVALID: empty DB
            return None
        while True:
            p = self._page(pgno)
            _, _, flags, _, _ = _PAGE_HDR.unpack_from(p, 0)
            offs = self._node_offsets(p)
            if flags & P_LEAF:
                for off in offs:
                    k, v = self._leaf_item(p, off)
                    if k == key:
                        return v
                return None
            assert flags & P_BRANCH, f"unexpected page flags {flags:#x}"
            # branch: first node's key is implicit-lowest; descend to the
            # last child whose key <= target
            child = None
            for i, off in enumerate(offs):
                k, pg = self._branch_item(p, off)
                if i == 0 or k <= key:
                    child = pg
                else:
                    break
            pgno = child

    def _iter_leaves(self, pgno: int) -> Iterator[memoryview]:
        p = self._page(pgno)
        _, _, flags, _, _ = _PAGE_HDR.unpack_from(p, 0)
        if flags & P_LEAF:
            yield p
            return
        for off in self._node_offsets(p):
            _, child = self._branch_item(p, off)
            yield from self._iter_leaves(child)

    def _iter_items(self) -> Iterator[Tuple[bytes, bytes]]:
        root = self._main_db["root"]
        if root == 0xFFFFFFFFFFFFFFFF:
            return
        for leaf in self._iter_leaves(root):
            for off in self._node_offsets(leaf):
                yield self._leaf_item(leaf, off)

    # -- lmdb-binding API subset --------------------------------------------
    def begin(self, write: bool = False, buffers: bool = False) -> Txn:
        return Txn(self)

    def close(self):
        self._mm.close()
        self._f.close()


def open(path: str, **kwargs) -> Env:  # noqa: A001 - mirrors lmdb.open
    """Read-only open; all lmdb.open flags are accepted and ignored."""
    return Env(path)


# ---------------------------------------------------------------------------
# Minimal writer (fixtures + dataset-preparation tools)
# ---------------------------------------------------------------------------

def _leaf_node(key: bytes, data: bytes, big: bool) -> bytes:
    dsize = len(data) if not big else len(data)  # dsize always true data size
    lo, hi = dsize & 0xFFFF, (dsize >> 16) & 0xFFFF
    flags = F_BIGDATA if big else 0
    payload = _PGNO.pack(0) if big else data  # pgno patched later
    return _NODE_HDR.pack(lo, hi, flags, len(key)) + key + payload


def _branch_node(key: bytes, pgno: int) -> bytes:
    lo, hi, fl = pgno & 0xFFFF, (pgno >> 16) & 0xFFFF, (pgno >> 32) & 0xFFFF
    return _NODE_HDR.pack(lo, hi, fl, len(key)) + key


def _pack_page(pgno: int, flags: int, nodes: List[bytes]) -> bytes:
    """Nodes grow DOWN from the page end; the u16 pointer array grows up."""
    ptrs = []
    upper = PAGE_SIZE
    body = bytearray(PAGE_SIZE)
    for node in nodes:
        n = len(node) + (len(node) & 1)  # even alignment
        upper -= n
        body[upper:upper + len(node)] = node
        ptrs.append(upper)
    lower = _HDR_SIZE + 2 * len(nodes)
    assert lower <= upper, "page overflow"
    _PAGE_HDR.pack_into(body, 0, pgno, 0, flags, lower, upper)
    struct.pack_into(f"<{len(ptrs)}H", body, _HDR_SIZE, *ptrs)
    return bytes(body)


def write_db(path: str, items: Dict[bytes, bytes]) -> None:
    """Write {key: value} as <path>/data.mdb (creates the directory).
    Values that don't fit in-page go to overflow pages (F_BIGDATA)."""
    os.makedirs(path, exist_ok=True)
    sorted_items = sorted((bytes(k), bytes(v)) for k, v in items.items())
    # in-page max data size: match liblmdb's default heuristic conservatively
    max_inline = (PAGE_SIZE - _HDR_SIZE) // 2 - 64

    pages: List[bytes] = [b"", b""]  # meta pages filled last
    next_pgno = 2

    # lay out leaves: greedy fill, overflow values out-of-line
    leaves: List[List[bytes]] = [[]]
    leaf_sizes = [0]
    overflow_patches: List[Tuple[int, int, int]] = []  # (leaf_i, node_i, pgno)
    overflow_pages: List[bytes] = []
    n_ovf = 0

    deferred: List[Tuple[int, int, bytes]] = []  # (leaf_idx, node_idx, data)
    for key, value in sorted_items:
        big = len(value) > max_inline
        node = _leaf_node(key, value, big)
        need = len(node) + (len(node) & 1) + 2
        if leaf_sizes[-1] + need > PAGE_SIZE - _HDR_SIZE - 16:
            leaves.append([])
            leaf_sizes.append(0)
        leaves[-1].append(node)
        leaf_sizes[-1] += need
        if big:
            deferred.append((len(leaves) - 1, len(leaves[-1]) - 1, value))

    n_leaves = len(leaves) if sorted_items else 0
    leaf_pgnos = list(range(next_pgno, next_pgno + n_leaves))
    next_pgno += n_leaves

    # overflow runs after the leaves
    for leaf_i, node_i, value in deferred:
        npages = -(-(len(value) + _HDR_SIZE) // PAGE_SIZE)
        header = bytearray(PAGE_SIZE * npages)
        _PAGE_HDR.pack_into(header, 0, next_pgno, 0, P_OVERFLOW, 0, 0)
        # pb field of an overflow page holds the page count (pb_pages u32)
        struct.pack_into("<I", header, 12, npages)
        header[_HDR_SIZE:_HDR_SIZE + len(value)] = value
        overflow_pages.append(bytes(header))
        # patch the node's trailing pgno
        node = bytearray(leaves[leaf_i][node_i])
        ksize = _NODE_HDR.unpack_from(node, 0)[3]
        _PGNO.pack_into(node, 8 + ksize, next_pgno)
        leaves[leaf_i][node_i] = bytes(node)
        next_pgno += npages
        n_ovf += npages

    for pgno, nodes in zip(leaf_pgnos, leaves):
        pages.append(_pack_page(pgno, P_LEAF, nodes))
    pages.extend(overflow_pages)

    depth = 1
    n_branch = 0
    if n_leaves == 0:
        root = 0xFFFFFFFFFFFFFFFF
    elif n_leaves == 1:
        root = leaf_pgnos[0]
    else:
        # single branch root (sufficient for fixture/tool scales; ~500k
        # entries with short keys)
        first_keys = []
        for nodes in leaves:
            ksize = _NODE_HDR.unpack_from(nodes[0], 0)[3]
            first_keys.append(bytes(nodes[0][8:8 + ksize]))
        branch_nodes = [
            _branch_node(b"" if i == 0 else first_keys[i], pg)
            for i, pg in enumerate(leaf_pgnos)
        ]
        root = next_pgno
        pages.append(_pack_page(root, P_BRANCH, branch_nodes))
        next_pgno += 1
        n_branch = 1
        depth = 2

    # meta pages
    def meta_page(pgno: int, txnid: int) -> bytes:
        body = bytearray(PAGE_SIZE)
        _PAGE_HDR.pack_into(body, 0, pgno, 0, P_META, 0, 0)
        _META.pack_into(body, _HDR_SIZE, MAGIC, VERSION, 0,
                        max(next_pgno * PAGE_SIZE, 1 << 20))
        off = _HDR_SIZE + _META.size
        free_db = (0, 0, 0, 0, 0, 0, 0, 0xFFFFFFFFFFFFFFFF)
        main_db = (0, 0, depth, n_branch, n_leaves, n_ovf,
                   len(sorted_items), root)
        _DB.pack_into(body, off, *free_db)
        _DB.pack_into(body, off + _DB.size, *main_db)
        _PGNO.pack_into(body, off + 2 * _DB.size, next_pgno - 1)  # last_pg
        _PGNO.pack_into(body, off + 2 * _DB.size + 8, txnid)
        return bytes(body)

    pages[0] = meta_page(0, 0)
    pages[1] = meta_page(1, 1)

    with builtins.open(os.path.join(path, "data.mdb"), "wb") as f:
        for p in pages:
            f.write(p)
