"""RPM database readers: sqlite and ndb container formats plus the RPM
header-blob codec (ref: pkg/fanal/analyzer/pkg/rpm/rpm.go, which delegates to
the external go-rpmdb; this is an independent implementation from the rpm
file-format documentation).

A package database stores one *header blob* per installed package. The blob
is the immutable RPM header region: big-endian ``il``/``dl`` counts, ``il``
16-byte index entries ``(tag, type, offset, count)``, then ``dl`` bytes of
data. Containers:

- **sqlite** (``rpmdb.sqlite``): table ``Packages(hnum INTEGER PRIMARY KEY,
  blob BLOB)``.
- **ndb** (``Packages.db``): little-endian; 32-byte file header (magic
  ``RpmP``, version, generation, slot page count), slot entries of 16 bytes
  (magic ``Slot``, pkgidx, blkoff, blkcnt) filling ``slotnpages`` 4 KiB
  pages, and 16-byte-aligned blob records (header magic ``BlbS``, pkgidx,
  checksum, length) holding the header blob.

- **bdb** (pre-rpm-4.16 ``Packages``): a BerkeleyDB *hash* database
  (libdb db_page.h layouts; the reference reads it through go-rpmdb,
  SURVEY §2.2). Page 0 is the hash metadata page (magic ``0x061561`` at
  offset 12, page size at 20, last_pgno at 32; a byte-swapped magic flags
  an opposite-endian file). Hash pages (type 2/13) carry a uint16 slot
  array of in-page offsets alternating key/data items; rpm keys are
  4-byte package numbers, and header blobs are usually ``H_OFFPAGE``
  items whose ``(pgno, tlen)`` chain of type-7 overflow pages carries the
  blob (``hf_offset`` = bytes used per overflow page).
"""

from __future__ import annotations

import sqlite3
import struct
import tempfile
from dataclasses import dataclass, field

# -- RPM header tag numbers (rpm tags.h; stable public ABI) ------------------
TAG_NAME = 1000
TAG_VERSION = 1001
TAG_RELEASE = 1002
TAG_EPOCH = 1003
TAG_SIZE = 1009
TAG_VENDOR = 1011
TAG_LICENSE = 1014
TAG_ARCH = 1022
TAG_SOURCERPM = 1044
TAG_PROVIDENAME = 1047
TAG_REQUIRENAME = 1049
TAG_DIRINDEXES = 1116
TAG_BASENAMES = 1117
TAG_DIRNAMES = 1118
TAG_MODULARITYLABEL = 5096
TAG_SIGMD5 = 261  # header dribble: signature md5 of the original package

# entry data types (rpm header spec)
T_NULL, T_CHAR, T_INT8, T_INT16, T_INT32, T_INT64 = 0, 1, 2, 3, 4, 5
T_STRING, T_BIN, T_STRING_ARRAY, T_I18NSTRING = 6, 7, 8, 9


class RpmDBError(ValueError):
    pass


@dataclass
class RpmHeader:
    """Decoded subset of one package header."""

    tags: dict[int, object] = field(default_factory=dict)

    def str_(self, tag: int, default: str = "") -> str:
        v = self.tags.get(tag)
        if isinstance(v, str):
            return v
        if isinstance(v, list) and v and isinstance(v[0], str):
            return v[0]
        return default

    def int_(self, tag: int, default: int = 0) -> int:
        v = self.tags.get(tag)
        if isinstance(v, int):
            return v
        if isinstance(v, list) and v and isinstance(v[0], int):
            return v[0]
        return default

    def list_(self, tag: int) -> list:
        v = self.tags.get(tag)
        if isinstance(v, list):
            return v
        if v is None:
            return []
        return [v]


_WANTED_TAGS = {
    TAG_NAME,
    TAG_VERSION,
    TAG_RELEASE,
    TAG_EPOCH,
    TAG_SIZE,
    TAG_VENDOR,
    TAG_LICENSE,
    TAG_ARCH,
    TAG_SOURCERPM,
    TAG_PROVIDENAME,
    TAG_REQUIRENAME,
    TAG_DIRINDEXES,
    TAG_BASENAMES,
    TAG_DIRNAMES,
    TAG_MODULARITYLABEL,
    TAG_SIGMD5,
}


def parse_header_blob(blob: bytes) -> RpmHeader:
    """Decode one header blob (no lead/magic: db blobs start at il/dl)."""
    if len(blob) < 8:
        raise RpmDBError("header blob too short")
    il, dl = struct.unpack_from(">II", blob, 0)
    if il > 0x10000 or dl > 0x10000000:
        raise RpmDBError(f"implausible header counts il={il} dl={dl}")
    entries_end = 8 + il * 16
    data_end = entries_end + dl
    if data_end > len(blob):
        raise RpmDBError("header blob truncated")
    data = blob[entries_end:data_end]
    hdr = RpmHeader()
    for i in range(il):
        tag, typ, off, cnt = struct.unpack_from(">iIII", blob, 8 + i * 16)
        if tag not in _WANTED_TAGS:
            continue
        hdr.tags[tag] = _decode_entry(data, typ, off, cnt)
    return hdr


def _decode_entry(data: bytes, typ: int, off: int, cnt: int):
    if typ in (T_STRING, T_I18NSTRING):
        end = data.find(b"\0", off)
        end = len(data) if end < 0 else end
        return data[off:end].decode("utf-8", "replace")
    if typ == T_STRING_ARRAY:
        out = []
        p = off
        for _ in range(cnt):
            end = data.find(b"\0", p)
            if end < 0:
                break
            out.append(data[p:end].decode("utf-8", "replace"))
            p = end + 1
        return out
    if typ == T_INT32:
        vals = list(struct.unpack_from(f">{cnt}i", data, off))
        return vals if cnt != 1 else vals[0]
    if typ == T_INT16:
        vals = list(struct.unpack_from(f">{cnt}h", data, off))
        return vals if cnt != 1 else vals[0]
    if typ == T_INT64:
        vals = list(struct.unpack_from(f">{cnt}q", data, off))
        return vals if cnt != 1 else vals[0]
    if typ in (T_CHAR, T_INT8):
        vals = list(data[off : off + cnt])
        return vals if cnt != 1 else vals[0]
    if typ == T_BIN:
        return data[off : off + cnt]
    return None


# -- containers --------------------------------------------------------------

_SQLITE_MAGIC = b"SQLite format 3\x00"
_NDB_MAGIC = b"RpmP"
_NDB_SLOT_MAGIC = struct.unpack("<I", b"Slot")[0]
_NDB_BLOB_MAGIC = struct.unpack("<I", b"BlbS")[0]
_BDB_HASH_MAGICS = (0x00061561, 0x61150600)


def _iter_sqlite_blobs(content: bytes):
    con = sqlite3.connect(":memory:")
    try:
        try:
            con.deserialize(content)
        except Exception:
            # some builds reject deserialize on odd page sizes; spill to disk
            con.close()
            with tempfile.NamedTemporaryFile(suffix=".sqlite") as f:
                f.write(content)
                f.flush()
                con = sqlite3.connect(f.name)
                yield from con.execute("SELECT blob FROM Packages ORDER BY hnum")
                return
        yield from con.execute("SELECT blob FROM Packages ORDER BY hnum")
    finally:
        con.close()


def _iter_ndb_blobs(content: bytes):
    if len(content) < 32:
        raise RpmDBError("ndb: file too short")
    magic, version, _gen, slotnpages = struct.unpack_from("<4sIII", content, 0)
    if magic != _NDB_MAGIC:
        raise RpmDBError("ndb: bad magic")
    if version != 0:
        raise RpmDBError(f"ndb: unsupported version {version}")
    if slotnpages == 0 or slotnpages > 2048:
        raise RpmDBError(f"ndb: implausible slot page count {slotnpages}")
    slots_end = min(slotnpages * 4096, len(content))
    # the 32-byte header occupies the first two 16-byte slot positions
    for pos in range(32, slots_end - 15, 16):
        smagic, pkgidx, blkoff, blkcnt = struct.unpack_from("<IIII", content, pos)
        if smagic != _NDB_SLOT_MAGIC or pkgidx == 0:
            continue
        boff = blkoff * 16
        if boff + 16 > len(content):
            raise RpmDBError("ndb: blob offset out of range")
        bmagic, bpkg, _cksum, blen = struct.unpack_from("<IIII", content, boff)
        if bmagic != _NDB_BLOB_MAGIC:
            raise RpmDBError("ndb: bad blob magic")
        if bpkg != pkgidx:
            raise RpmDBError("ndb: blob/slot package index mismatch")
        if boff + 16 + blen > len(content) or blen > blkcnt * 16:
            raise RpmDBError("ndb: blob length out of range")
        yield pkgidx, content[boff + 16 : boff + 16 + blen]


# BDB page types (libdb db_page.h)
_BDB_P_OVERFLOW = 7
_BDB_P_HASHMETA = 8
_BDB_HASH_PAGES = (2, 13)  # P_HASH_UNSORTED, P_HASH
# hash item types
_BDB_H_KEYDATA = 1
_BDB_H_OFFPAGE = 3
_BDB_PAGE_HDR = 26


def _iter_bdb_blobs(content: bytes):
    """(pkg_number, header_blob) pairs from a BerkeleyDB hash ``Packages``."""
    if len(content) < 512:
        raise RpmDBError("bdb: file too short")
    (magic_le,) = struct.unpack_from("<I", content, 12)
    if magic_le == _BDB_HASH_MAGICS[0]:
        E = "<"
    elif magic_le == _BDB_HASH_MAGICS[1]:
        E = ">"
    else:
        raise RpmDBError("bdb: bad hash metadata magic")
    (pagesize,) = struct.unpack_from(E + "I", content, 20)
    if content[25] != _BDB_P_HASHMETA:
        raise RpmDBError("bdb: page 0 is not a hash metadata page")
    if pagesize < 512 or pagesize > 64 * 1024 or pagesize & (pagesize - 1):
        raise RpmDBError(f"bdb: implausible page size {pagesize}")
    (last_pgno,) = struct.unpack_from(E + "I", content, 32)
    npages = min(last_pgno + 1, len(content) // pagesize)

    def overflow_chain(pgno: int, tlen: int) -> bytes:
        out = bytearray()
        seen = set()
        while pgno and len(out) < tlen:
            if pgno in seen or pgno >= npages:
                raise RpmDBError("bdb: broken overflow chain")
            seen.add(pgno)
            base = pgno * pagesize
            if content[base + 25] != _BDB_P_OVERFLOW:
                raise RpmDBError("bdb: expected overflow page")
            (next_pgno,) = struct.unpack_from(E + "I", content, base + 16)
            (used,) = struct.unpack_from(E + "H", content, base + 22)
            used = min(used, pagesize - _BDB_PAGE_HDR)
            out += content[base + _BDB_PAGE_HDR : base + _BDB_PAGE_HDR + used]
            pgno = next_pgno
        if len(out) < tlen:
            raise RpmDBError("bdb: truncated overflow item")
        return bytes(out[:tlen])

    for pgno in range(1, npages):
        base = pgno * pagesize
        if content[base + 25] not in _BDB_HASH_PAGES:
            continue
        (entries,) = struct.unpack_from(E + "H", content, base + 20)
        if entries < 2 or _BDB_PAGE_HDR + 2 * entries > pagesize:
            continue
        inp = struct.unpack_from(E + f"{entries}H", content, base + _BDB_PAGE_HDR)

        def item_len(k: int) -> int:
            # items fill the page back-to-front in slot order, so an item
            # runs from its offset to the previous slot's offset (page end
            # for slot 0) — libdb's LEN_HITEM
            hi = pagesize if k == 0 else inp[k - 1]
            return hi - inp[k]

        for i in range(0, entries - 1, 2):
            koff, doff = inp[i], inp[i + 1]
            if not (0 < koff < pagesize and 0 < doff < pagesize):
                continue
            if content[base + koff] != _BDB_H_KEYDATA:
                continue  # off-page/duplicate keys never happen for rpm
            klen = item_len(i) - 1
            key = content[base + koff + 1 : base + koff + 1 + klen]
            pkgidx = (
                struct.unpack(E + "I", key)[0] if klen == 4 else 0
            )
            if pkgidx == 0:
                continue  # rpm package numbers start at 1
            dtype = content[base + doff]
            if dtype == _BDB_H_OFFPAGE:
                opgno, tlen = struct.unpack_from(E + "II", content, base + doff + 4)
                yield pkgidx, overflow_chain(opgno, tlen)
            elif dtype == _BDB_H_KEYDATA:
                dlen = item_len(i + 1) - 1
                yield pkgidx, content[base + doff + 1 : base + doff + 1 + dlen]


def detect_format(content: bytes) -> str:
    if content.startswith(_SQLITE_MAGIC):
        return "sqlite"
    if content.startswith(_NDB_MAGIC):
        return "ndb"
    if len(content) >= 16:
        (m,) = struct.unpack_from("<I", content, 12)
        if m in _BDB_HASH_MAGICS:
            return "bdb"
    return "unknown"


def read_headers(content: bytes) -> list[RpmHeader]:
    """All package headers in db insertion order."""
    fmt = detect_format(content)
    if fmt == "sqlite":
        rows = [(i, r[0]) for i, r in enumerate(_iter_sqlite_blobs(content))]
    elif fmt == "ndb":
        rows = sorted(_iter_ndb_blobs(content), key=lambda t: t[0])
    elif fmt == "bdb":
        rows = sorted(_iter_bdb_blobs(content), key=lambda t: t[0])
    else:
        raise RpmDBError("unrecognized rpmdb format")
    out = []
    for _, blob in rows:
        if not blob:
            continue
        out.append(parse_header_blob(bytes(blob)))
    return out
