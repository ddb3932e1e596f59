"""Read-only bbolt (boltdb) file parser + minimal writer.

The real trivy-db ships as a bbolt B+tree file inside an OCI artifact
(ref: pkg/db/db.go:27-35; bucket schema per aquasecurity/trivy-db and the
reference's bolt fixtures, e.g.
pkg/detector/library/testdata/fixtures/pip.yaml: root buckets
``"<eco>::<source>"`` / ``"<family> <release>"`` / ``data-source`` /
``vulnerability``, one nested bucket per package, key = vulnerability ID,
value = JSON advisory). This module reads that file format directly so a
user-supplied ``trivy.db`` converts into the flattened shard layout without
any Go tooling; the writer exists to build fixture/scale DBs for tests and
benchmarks (the reference does the same with bolt-fixtures,
internal/dbtest/db.go:18-37).

bbolt on-disk format (github.com/etcd-io/bbolt, db.go/page.go):

- fixed-size pages; page header = id u64, flags u16, count u16, overflow u32
- flags: 0x01 branch, 0x02 leaf, 0x04 meta, 0x10 freelist
- meta page body: magic 0xED0CDAED u32, version=2 u32, pageSize u32,
  flags u32, root bucket (pgid u64 + sequence u64), freelist pgid u64,
  high-water pgid u64, txid u64, checksum u64 (FNV-1a over the first 56
  body bytes); two meta pages (0 and 1), highest valid txid wins
- branch element (16 B): pos u32, ksize u32, pgid u64; key at elem+pos
- leaf element (16 B): flags u32, pos u32, ksize u32, vsize u32; key at
  elem+pos, value right after the key; flags&0x01 marks a nested bucket
- nested bucket value = bucket header (root pgid u64, sequence u64);
  root pgid 0 means the bucket is *inline*: its page follows the header
  inside the value
- values larger than one page spill into ``overflow`` contiguous pages
"""

from __future__ import annotations

import os
import struct
from collections.abc import Iterator

MAGIC = 0xED0CDAED
VERSION = 2

FLAG_BRANCH = 0x01
FLAG_LEAF = 0x02
FLAG_META = 0x04
FLAG_FREELIST = 0x10

LEAF_BUCKET = 0x01

PAGE_HDR = 16  # id(8) flags(2) count(2) overflow(4)
LEAF_ELEM = 16
BRANCH_ELEM = 16
BUCKET_HDR = 16  # root pgid(8) sequence(8)

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


class BoltError(Exception):
    pass


class BoltDB:
    """Read-only view over a bbolt file; values returned as bytes."""

    def __init__(self, path: str):
        import mmap

        self.path = path
        self._f = open(path, "rb")
        try:
            # a real trivy-db is hundreds of MB; map it instead of slurping
            # (the parser only does random slicing)
            self._data = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty file mmap fails on linux
            self._data = self._f.read()
        if len(self._data) < 2 * 4096:
            raise BoltError("file too small for bbolt meta pages")
        # both meta candidates assume the default 4 KiB page long enough to
        # read the real pageSize from the winning meta
        metas = []
        for off in (0, 4096):
            m = self._read_meta(off)
            if m is not None:
                metas.append(m)
        if not metas:
            raise BoltError("no valid bbolt meta page")
        meta = max(metas, key=lambda m: m["txid"])
        self.page_size = meta["page_size"]
        self.root_pgid = meta["root"]
        if self.page_size != 4096:
            # re-read metas at the true page size (page 1 moves)
            metas = [
                m
                for off in (0, self.page_size)
                if (m := self._read_meta(off)) is not None
            ]
            meta = max(metas, key=lambda m: m["txid"])
            self.root_pgid = meta["root"]

    def _read_meta(self, off: int) -> dict | None:
        body = self._data[off + PAGE_HDR : off + PAGE_HDR + 64]
        if len(body) < 64:
            return None
        magic, version, page_size, _flags = struct.unpack_from("<IIII", body, 0)
        if magic != MAGIC or version != VERSION:
            return None
        root, _seq, _freelist, _hw, txid, checksum = struct.unpack_from(
            "<QQQQQQ", body, 16
        )
        if checksum and checksum != _fnv1a(body[:56]):
            return None
        return {"page_size": page_size, "root": root, "txid": txid}

    # -- page access ---------------------------------------------------------

    def _page(self, pgid: int) -> tuple[int, int, int, int]:
        """(offset, flags, count, overflow) of a page."""
        off = pgid * self.page_size
        if off + PAGE_HDR > len(self._data):
            raise BoltError(f"page {pgid} out of range")
        _pid, flags, count, overflow = struct.unpack_from(
            "<QHHI", self._data, off
        )
        return off, flags, count, overflow

    # -- traversal ------------------------------------------------------------

    def _iter_leaf_at(
        self, base: int, count: int
    ) -> Iterator[tuple[int, bytes, bytes]]:
        """Yield (flags, key, value) from a leaf page body at ``base``
        (start of the element array, i.e. page offset + PAGE_HDR)."""
        d = self._data
        for i in range(count):
            eoff = base + i * LEAF_ELEM
            flags, pos, ksize, vsize = struct.unpack_from("<IIII", d, eoff)
            kstart = eoff + pos
            yield flags, bytes(d[kstart : kstart + ksize]), bytes(
                d[kstart + ksize : kstart + ksize + vsize]
            )

    def _iter_node(self, pgid: int) -> Iterator[tuple[int, bytes, bytes]]:
        """Depth-first key iteration of the B+tree rooted at page ``pgid``."""
        off, flags, count, _overflow = self._page(pgid)
        base = off + PAGE_HDR
        if flags & FLAG_LEAF:
            yield from self._iter_leaf_at(base, count)
        elif flags & FLAG_BRANCH:
            d = self._data
            for i in range(count):
                eoff = base + i * BRANCH_ELEM
                _pos, _ksize, child = struct.unpack_from("<IIQ", d, eoff)
                yield from self._iter_node(child)
        else:
            raise BoltError(f"page {pgid}: unexpected flags {flags:#x}")

    def _iter_bucket_value(
        self, value: bytes
    ) -> Iterator[tuple[int, bytes, bytes]]:
        """Iterate a nested bucket from its leaf value (header + optional
        inline page)."""
        root, _seq = struct.unpack_from("<QQ", value, 0)
        if root != 0:
            yield from self._iter_node(root)
            return
        # inline bucket: a pageless leaf page embedded after the header;
        # element positions are relative to each element's own start, so
        # iterating over the value slice directly is exact
        _pid, flags, count, _ov = struct.unpack_from("<QHHI", value, BUCKET_HDR)
        if not flags & FLAG_LEAF:
            raise BoltError("inline bucket without leaf flag")
        d = value[BUCKET_HDR:]
        for i in range(count):
            eoff = PAGE_HDR + i * LEAF_ELEM
            eflags, pos, ksize, vsize = struct.unpack_from("<IIII", d, eoff)
            kstart = eoff + pos
            yield eflags, d[kstart : kstart + ksize], d[
                kstart + ksize : kstart + ksize + vsize
            ]

    # -- public API -----------------------------------------------------------

    def buckets(self) -> list[bytes]:
        """Top-level bucket names."""
        return [
            k
            for flags, k, _v in self._iter_node(self.root_pgid)
            if flags & LEAF_BUCKET
        ]

    def walk_bucket(
        self, name: bytes
    ) -> Iterator[tuple[bytes, bytes | None, dict[bytes, bytes]]]:
        """Iterate a top-level bucket.

        Yields ``(key, value, {})`` for plain keys and
        ``(key, None, {subkey: subvalue})`` for nested buckets (the
        trivy-db package level).
        """
        for flags, k, v in self._iter_node(self.root_pgid):
            if k != name or not flags & LEAF_BUCKET:
                continue
            for sflags, sk, sv in self._iter_bucket_value(v):
                if sflags & LEAF_BUCKET:
                    sub = {
                        bytes(k2): bytes(v2)
                        for f2, k2, v2 in self._iter_bucket_value(sv)
                        if not f2 & LEAF_BUCKET
                    }
                    yield bytes(sk), None, sub
                else:
                    yield bytes(sk), bytes(sv), {}
            return


class BoltWriter:
    """Minimal bbolt writer producing files :class:`BoltDB` (and bbolt
    itself) can read: sequentially allocated pages, multi-level branch
    pages when needed, no freelist reuse. Keys must be pre-sorted per
    bucket for valid B+tree ordering."""

    def __init__(self, page_size: int = 4096):
        self.page_size = page_size
        self.pages: list[bytes] = []  # data pages, pgid = index + 4

    def _alloc(self, raw: bytes, flags: int, count: int) -> tuple[int, int]:
        """Store a page body; returns (pgid, overflow)."""
        body_cap = self.page_size - PAGE_HDR
        overflow = (
            0 if len(raw) <= body_cap else -(-(len(raw) - body_cap) // self.page_size)
        )
        pgid = 4 + len(self.pages)
        total = (1 + overflow) * self.page_size
        page = struct.pack("<QHHI", pgid, flags, count, overflow) + raw
        page += b"\x00" * (total - len(page))
        for i in range(0, total, self.page_size):
            self.pages.append(page[i : i + self.page_size])
        return pgid, overflow

    def _write_leaf(self, items: list[tuple[int, bytes, bytes]]) -> int:
        """One leaf page (caller splits batches; big values ride overflow
        pages)."""
        n = len(items)
        cursor = n * LEAF_ELEM
        elems = b""
        data = b""
        for i, (flags, k, v) in enumerate(items):
            rel = cursor - i * LEAF_ELEM
            elems += struct.pack("<IIII", flags, rel, len(k), len(v))
            data += k + v
            cursor += len(k) + len(v)
        pgid, _ = self._alloc(elems + data, FLAG_LEAF, n)
        return pgid

    def _write_tree(self, items: list[tuple[int, bytes, bytes]]) -> int:
        """Split items across leaves and build branches bottom-up."""
        if not items:
            return self._write_leaf([])
        body_cap = self.page_size - PAGE_HDR
        leaves: list[tuple[bytes, int]] = []  # (first key, pgid)
        batch: list[tuple[int, bytes, bytes]] = []
        used = 0
        for it in items:
            sz = LEAF_ELEM + len(it[1]) + len(it[2])
            # a single huge item gets its own page (+overflow)
            if batch and used + sz > body_cap:
                leaves.append((batch[0][1], self._write_leaf(batch)))
                batch, used = [], 0
            batch.append(it)
            used += sz
        if batch:
            leaves.append((batch[0][1], self._write_leaf(batch)))
        # build branch levels until a single root remains
        level = leaves
        while len(level) > 1:
            nxt: list[tuple[bytes, int]] = []
            bb: list[tuple[bytes, int]] = []
            bused = 0
            for key, pgid in level:
                sz = BRANCH_ELEM + len(key)
                if bb and bused + sz > body_cap:
                    nxt.append((bb[0][0], self._write_branch(bb)))
                    bb, bused = [], 0
                bb.append((key, pgid))
                bused += sz
            if bb:
                nxt.append((bb[0][0], self._write_branch(bb)))
            level = nxt
        return level[0][1]

    def _write_branch(self, children: list[tuple[bytes, int]]) -> int:
        n = len(children)
        cursor = n * BRANCH_ELEM
        elems = b""
        data = b""
        for i, (key, pgid) in enumerate(children):
            rel = cursor - i * BRANCH_ELEM
            elems += struct.pack("<IIQ", rel, len(key), pgid)
            data += key
            cursor += len(key)
        pgid, _ = self._alloc(elems + data, FLAG_BRANCH, n)
        return pgid

    def write(self, path: str, buckets: dict[bytes, dict]) -> None:
        """``buckets``: name -> {key: bytes-value | dict (nested bucket)}."""

        def bucket_value(content: dict) -> bytes:
            items: list[tuple[int, bytes, bytes]] = []
            for k in sorted(content):
                v = content[k]
                if isinstance(v, dict):
                    items.append((LEAF_BUCKET, k, bucket_value(v)))
                else:
                    items.append((0, k, v))
            root = self._write_tree(items)
            return struct.pack("<QQ", root, 0)

        top: list[tuple[int, bytes, bytes]] = []
        for name in sorted(buckets):
            top.append((LEAF_BUCKET, name, bucket_value(buckets[name])))
        root_pgid = self._write_tree(top)

        # freelist page (empty) and meta pages
        freelist_pgid = 4 + len(self.pages)
        self.pages.append(
            struct.pack("<QHHI", freelist_pgid, FLAG_FREELIST, 0, 0).ljust(
                self.page_size, b"\x00"
            )
        )
        high_water = 4 + len(self.pages)

        def meta_page(pgid: int, txid: int) -> bytes:
            body = struct.pack(
                "<IIII", MAGIC, VERSION, self.page_size, 0
            ) + struct.pack(
                "<QQQQQ", root_pgid, 0, freelist_pgid, high_water, txid
            )
            body += struct.pack("<Q", _fnv1a(body))
            page = struct.pack("<QHHI", pgid, FLAG_META, 0, 0) + body
            return page.ljust(self.page_size, b"\x00")

        with open(path, "wb") as f:
            f.write(meta_page(0, 0))
            f.write(meta_page(1, 1))
            # pages 2-3 reserved in real bbolt for the initial freelist and
            # an empty leaf; keep placeholders so pgids 4.. line up
            f.write(struct.pack("<QHHI", 2, FLAG_FREELIST, 0, 0).ljust(self.page_size, b"\x00"))
            f.write(struct.pack("<QHHI", 3, FLAG_LEAF, 0, 0).ljust(self.page_size, b"\x00"))
            for p in self.pages:
                f.write(p)
