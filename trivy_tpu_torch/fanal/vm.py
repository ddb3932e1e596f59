"""VM disk-image walker: raw disk → partition table → ext4 file walk, the
port's copy of ``trivy_tpu/fanal/vm.py``.

Pure-Python analog of the reference's VM walker (ref:
pkg/fanal/walker/vm.go:57 — go-disk for MBR/GPT, go-ext4-filesystem for
the filesystem; LVM is skipped there too). Scope: raw images (and
anything byte-identical to one), MBR + GPT partition tables, read-only
ext4 with extent-mapped files. XFS and LVM partitions are detected and
skipped with a warning rather than failing the scan.

The ext4 reader implements just enough of the on-disk format for
scanning: superblock, group descriptors (32/64-bit), inodes, extent
trees, and linear directory iteration (htree directories degrade to
linear scans by design — leaf blocks hold ordinary dirents).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from trivy_tpu_torch import log

logger = log.logger("walker:vm")

SECTOR = 512

EXT4_MAGIC = 0xEF53
XFS_MAGIC = b"XFSB"
LVM_MAGIC = b"LABELONE"

# inode type bits
S_IFMT = 0xF000
S_IFDIR = 0x4000
S_IFREG = 0x8000

EXTENT_MAGIC = 0xF30A
ROOT_INODE = 2


class SectionReader:
    """Bounded random-access view over a file object."""

    def __init__(self, f, offset: int, size: int):
        self._f = f
        self.offset = offset
        self.size = size

    def read_at(self, off: int, n: int) -> bytes:
        if off < 0 or off + n > self.size:
            n = max(0, min(n, self.size - off))
        self._f.seek(self.offset + off)
        return self._f.read(n)

    def section(self, off: int, size: int) -> "SectionReader":
        return SectionReader(self._f, self.offset + off, min(size, self.size - off))


@dataclass
class Partition:
    name: str
    reader: SectionReader
    type_id: str = ""

    @property
    def bootable_hint(self) -> bool:
        # EFI system / BIOS boot partitions carry no scan targets
        return self.type_id in ("0xef", "EFI", "BIOS")


def partitions(reader: SectionReader) -> list[Partition]:
    """Partition list from GPT (preferred) or MBR; a disk with neither is
    treated as one whole-disk filesystem (common for fixture images)."""
    gpt = _parse_gpt(reader)
    if gpt:
        return gpt
    mbr = _parse_mbr(reader)
    if mbr:
        return mbr
    return [Partition("disk", reader)]


def _parse_gpt(reader: SectionReader) -> list[Partition]:
    hdr = reader.read_at(SECTOR, 92)
    if len(hdr) < 92 or hdr[:8] != b"EFI PART":
        return []
    entries_lba, n_entries, entry_size = struct.unpack_from("<QII", hdr, 72)
    out = []
    raw = reader.read_at(entries_lba * SECTOR, n_entries * entry_size)
    for i in range(n_entries):
        e = raw[i * entry_size : (i + 1) * entry_size]
        if len(e) < 128 or e[:16] == b"\x00" * 16:
            continue
        first_lba, last_lba = struct.unpack_from("<QQ", e, 32)
        name = e[56:128].decode("utf-16-le", "ignore").rstrip("\x00") or f"part{i}"
        out.append(
            Partition(
                name,
                reader.section(first_lba * SECTOR, (last_lba - first_lba + 1) * SECTOR),
                type_id="EFI" if e[:16] == bytes.fromhex(
                    "28732ac11ff8d211ba4b00a0c93ec93b"
                ) else "",
            )
        )
    return out


def _parse_mbr(reader: SectionReader) -> list[Partition]:
    sec0 = reader.read_at(0, SECTOR)
    if len(sec0) < SECTOR or sec0[510:512] != b"\x55\xaa":
        return []
    out = []
    for i in range(4):
        e = sec0[446 + i * 16 : 446 + (i + 1) * 16]
        ptype = e[4]
        if ptype == 0:
            continue
        lba, sectors = struct.unpack_from("<II", e, 8)
        if sectors == 0:
            continue
        if ptype in (0x05, 0x0F):  # extended partition: walk the EBR chain
            out.extend(_parse_ebr(reader, lba))
            continue
        out.append(
            Partition(
                f"part{i}",
                reader.section(lba * SECTOR, sectors * SECTOR),
                type_id=hex(ptype),
            )
        )
    return out


def _parse_ebr(reader: SectionReader, ext_start: int) -> list[Partition]:
    out = []
    offset = 0
    for n in range(128):  # defensive bound on the chain
        sec = reader.read_at((ext_start + offset) * SECTOR, SECTOR)
        if len(sec) < SECTOR or sec[510:512] != b"\x55\xaa":
            break
        e = sec[446:462]
        lba, sectors = struct.unpack_from("<II", e, 8)
        if e[4] != 0 and sectors:
            out.append(
                Partition(
                    f"logical{n}",
                    reader.section((ext_start + offset + lba) * SECTOR, sectors * SECTOR),
                    type_id=hex(e[4]),
                )
            )
        nxt = sec[462:478]
        nlba, nsec = struct.unpack_from("<II", nxt, 8)
        if nxt[4] == 0 or nsec == 0:
            break
        offset = nlba
    return out


# ---------------------------------------------------------------------------
# ext4 (read-only, extents)
# ---------------------------------------------------------------------------

INCOMPAT_64BIT = 0x80
INCOMPAT_FILETYPE = 0x2


class Ext4Error(ValueError):
    pass


class Ext4:
    def __init__(self, reader: SectionReader):
        sb = reader.read_at(1024, 1024)
        if len(sb) < 1024 or struct.unpack_from("<H", sb, 0x38)[0] != EXT4_MAGIC:
            raise Ext4Error("not an ext4 filesystem")
        self.r = reader
        log_block = struct.unpack_from("<I", sb, 24)[0]
        self.block_size = 1024 << log_block
        self.blocks_per_group = struct.unpack_from("<I", sb, 32)[0]
        self.inodes_per_group = struct.unpack_from("<I", sb, 40)[0]
        self.inode_size = struct.unpack_from("<H", sb, 88)[0] or 128
        self.incompat = struct.unpack_from("<I", sb, 96)[0]
        self.first_data_block = struct.unpack_from("<I", sb, 20)[0]
        if self.incompat & INCOMPAT_64BIT:
            self.desc_size = struct.unpack_from("<H", sb, 254)[0] or 64
        else:
            self.desc_size = 32
        # group descriptor table: the block after the superblock's block
        self._gdt_block = self.first_data_block + 1

    def _block(self, n: int) -> bytes:
        return self.r.read_at(n * self.block_size, self.block_size)

    def _inode_table(self, group: int) -> int:
        off = self._gdt_block * self.block_size + group * self.desc_size
        raw = self.r.read_at(off, self.desc_size)
        lo = struct.unpack_from("<I", raw, 8)[0]
        if self.desc_size >= 64:
            hi = struct.unpack_from("<I", raw, 0x28)[0]
            return (hi << 32) | lo
        return lo

    def read_inode(self, num: int) -> dict:
        group, index = divmod(num - 1, self.inodes_per_group)
        table = self._inode_table(group)
        off = table * self.block_size + index * self.inode_size
        raw = self.r.read_at(off, self.inode_size)
        if len(raw) < 128:
            raise Ext4Error(f"short inode read: {num}")
        mode, _uid, size_lo = struct.unpack_from("<HHI", raw, 0)
        size_hi = struct.unpack_from("<I", raw, 108)[0]
        flags = struct.unpack_from("<I", raw, 32)[0]
        return {
            "mode": mode,
            "size": (size_hi << 32) | size_lo,
            "flags": flags,
            "i_block": raw[40:100],
        }

    # -- extent tree ---------------------------------------------------------

    def _extents(self, node: bytes) -> list[tuple[int, int, int, bool]]:
        """(logical_block, length, physical_block, unwritten) tuples from an
        extent node, recursing through index nodes."""
        magic, entries, _max, depth = struct.unpack_from("<HHHH", node, 0)
        if magic != EXTENT_MAGIC:
            raise Ext4Error("non-extent-mapped inode (ext2-style mapping)")
        out = []
        if depth == 0:
            for i in range(entries):
                e = node[12 + i * 12 : 24 + i * 12]
                lblk, ln, hi, lo = struct.unpack("<IHHI", e)
                # ee_len semantics (kernel ext4_ext_is_unwritten): an extent
                # is unwritten iff ee_len > 32768; ee_len == 32768 is a
                # maximal *initialized* extent (EXT_INIT_MAX_LEN), so a plain
                # high-bit mask would misread 128 MiB written runs as empty
                unwritten = ln > 32768
                if unwritten:
                    ln -= 32768
                out.append((lblk, ln, (hi << 32) | lo, unwritten))
            return out
        for i in range(entries):
            e = node[12 + i * 12 : 24 + i * 12]
            _lblk, lo, hi, _pad = struct.unpack("<IIHH", e)
            child = self._block((hi << 32) | lo)
            out.extend(self._extents(child))
        return out

    def read_file(self, inode: dict, cap: int | None = None) -> bytes:
        size = inode["size"] if cap is None else min(inode["size"], cap)
        chunks = []
        got = 0
        for lblk, ln, pblk, unwritten in sorted(self._extents(inode["i_block"])):
            if lblk * self.block_size >= size:
                break
            nbytes = ln * self.block_size
            # ext4 semantics: unwritten (preallocated) extents read as zeros,
            # not whatever stale bytes sit on disk at the physical location
            if unwritten:
                data = b"\x00" * nbytes
            else:
                data = self.r.read_at(pblk * self.block_size, nbytes)
            # sparse gap between extents fills with zeros
            gap = lblk * self.block_size - got
            if gap > 0:
                chunks.append(b"\x00" * gap)
                got += gap
            chunks.append(data)
            got += len(data)
        out = b"".join(chunks)[:size]
        if len(out) < size:  # trailing sparse hole
            out += b"\x00" * (size - len(out))
        return out

    # -- directories ---------------------------------------------------------

    def iter_dir(self, inode: dict):
        """(name, inode_number, is_dir) entries; '.'/'..' skipped; htree
        internal nodes are skipped naturally via inode==0 records."""
        data = self.read_file(inode)
        off = 0
        while off + 8 <= len(data):
            ino, rec_len, name_len, ftype = struct.unpack_from("<IHBB", data, off)
            if rec_len < 8:
                break
            if ino != 0 and name_len:
                name = data[off + 8 : off + 8 + name_len].decode("utf-8", "replace")
                if name not in (".", ".."):
                    if self.incompat & INCOMPAT_FILETYPE:
                        is_dir = ftype == 2
                    else:
                        child = self.read_inode(ino)
                        is_dir = (child["mode"] & S_IFMT) == S_IFDIR
                    yield name, ino, is_dir
            off += rec_len

    def walk(self, max_depth: int = 64):
        """Yields (path, inode_dict) for every regular file."""
        seen: set[int] = set()

        def rec(ino_num: int, prefix: str, depth: int):
            if depth > max_depth or ino_num in seen:
                return
            seen.add(ino_num)
            inode = self.read_inode(ino_num)
            for name, child_num, is_dir in self.iter_dir(inode):
                path = f"{prefix}{name}"
                if is_dir:
                    rec(child_num, path + "/", depth + 1)
                else:
                    try:
                        child = self.read_inode(child_num)
                    except Ext4Error as e:
                        logger.debug("inode %d unreadable: %s", child_num, e)
                        continue
                    if (child["mode"] & S_IFMT) == S_IFREG:
                        yield_queue.append((path, child))

        yield_queue: list = []
        rec(ROOT_INODE, "", 0)
        yield from yield_queue


def detect_filesystem(part: Partition) -> str:
    """'ext4' | 'xfs' | 'lvm' | 'unknown'."""
    head = part.reader.read_at(0, 8)
    if head[:8] == LVM_MAGIC or part.reader.read_at(SECTOR, 8)[:8] == LVM_MAGIC:
        return "lvm"
    if head[:4] == XFS_MAGIC:
        return "xfs"
    sb = part.reader.read_at(1024, 0x40)
    if len(sb) >= 0x3A and struct.unpack_from("<H", sb, 0x38)[0] == EXT4_MAGIC:
        return "ext4"
    return "unknown"


def walk_disk(path: str, max_file_size: int = 64 << 20):
    """Walk every scannable partition of a raw disk image.

    Yields (partition_name, file_path, size, opener) — the same lazy-opener
    shape the fs walker feeds analyzers with.
    """
    f = open(path, "rb")
    import os

    disk_size = os.fstat(f.fileno()).st_size
    reader = SectionReader(f, 0, disk_size)
    try:
        for part in partitions(reader):
            if part.bootable_hint:
                continue
            kind = detect_filesystem(part)
            if kind == "ext4":
                try:
                    fs = Ext4(part.reader)
                    # ext2/ext3 share the superblock magic; their
                    # block-mapped inodes raise during the walk, so the
                    # guard covers the whole traversal, not just mount
                    files = list(fs.walk())
                except Ext4Error as e:
                    logger.warning("%s: %s — skipping partition", part.name, e)
                    continue
                for fpath, inode in files:
                    if inode["size"] > max_file_size:
                        continue
                    yield (
                        part.name,
                        fpath,
                        inode["size"],
                        (lambda fs=fs, inode=inode: fs.read_file(inode)),
                    )
            elif kind in ("lvm", "xfs"):
                logger.warning(
                    "%s: %s is not supported, skipping (the reference skips "
                    "LVM the same way)", part.name, kind,
                )
    finally:
        # opener closures hold fs objects that read through f; the caller
        # must consume the generator before the file closes
        f.close()
