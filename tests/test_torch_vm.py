"""``vm`` of the port against the JAX package's, on real ext4 images that
``mkfs.ext4 -d`` builds (no mount needed; skipped where the tool is
missing, as ``tests/test_vm.py`` is): the disk walk's files and bytes, an
unwritten extent, disks partitioned by MBR (primary and logical) and GPT,
``vm`` through both CLIs (``Results`` and ``Metadata`` equal, exactly) and
the cache hit of a rescan."""

import json
import shutil
import struct
import subprocess
from pathlib import Path

import pytest

from tests.dbtest import build_db
from tests.test_torch_fs_vuln import make_tree
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu.fanal import vm as jax_vm
from trivy_tpu_torch import cli
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.fanal import vm as port_vm

SECTOR = 512
START_LBA = 2048


@pytest.fixture(scope="module")
def disks(tmp_path_factory):
    """An ext4 image of ``test_torch_fs_vuln.make_tree`` (every lockfile
    kind, an alpine root, binaries, a secret, a license) with a 300 KB
    multi-block file, and the same filesystem inside MBR, logical and GPT
    partitioned disks."""
    mkfs = shutil.which("mkfs.ext4")
    if mkfs is None:
        pytest.skip("mkfs.ext4 not available")
    tmp = tmp_path_factory.mktemp("vm")
    root = tmp / "root"
    make_tree(root)
    (root / "data" / "big.bin").parent.mkdir()
    (root / "data" / "big.bin").write_bytes(b"A" * 300_000)
    size = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())
    img = tmp / "disk.img"
    with open(img, "wb") as f:
        f.truncate(((2 * size >> 20) + 16) << 20)
    subprocess.run([mkfs, "-q", "-d", str(root), str(img)], check=True)
    fs = img.read_bytes()
    return {"root": root, "ext4": img, "fs": fs, "db": build_db(tmp),
            **{kind: wrap(tmp / f"{kind}.img", fs, kind) for kind in ("mbr", "logical", "gpt")}}


def mbr_entry(ptype: int, lba: int, sectors: int) -> bytes:
    return struct.pack("<BBBBBBBBII", 0, 0, 0, 0, ptype, 0, 0, 0, lba, sectors)


def wrap(path: Path, fs: bytes, kind: str) -> Path:
    """``fs`` at LBA 2048 of a disk partitioned as ``kind``: one primary
    MBR partition, a logical one in an extended partition's EBR chain, or
    one GPT entry."""
    n = len(fs) // SECTOR
    with open(path, "wb") as f:
        sec0 = bytearray(SECTOR)
        sec0[510:512] = b"\x55\xaa"
        if kind == "mbr":
            sec0[446:462] = mbr_entry(0x83, START_LBA, n)
        elif kind == "logical":
            ext = START_LBA - 64  # the EBR sits at the extended partition's start
            sec0[446:462] = mbr_entry(0x05, ext, n + 64)
            ebr = bytearray(SECTOR)
            ebr[446:462] = mbr_entry(0x83, 64, n)
            ebr[510:512] = b"\x55\xaa"
            f.seek(ext * SECTOR)
            f.write(ebr)
        else:
            hdr = bytearray(92)
            hdr[:8] = b"EFI PART"
            struct.pack_into("<QII", hdr, 72, 2, 4, 128)
            entry = bytearray(128)
            entry[:16] = bytes(range(1, 17))  # a Linux-data-like type GUID
            struct.pack_into("<QQ", entry, 32, START_LBA, START_LBA + n - 1)
            entry[56:56 + 8] = "root".encode("utf-16-le")
            f.seek(SECTOR)
            f.write(hdr)
            f.seek(2 * SECTOR)
            f.write(entry)
            sec0 = None
        if sec0 is not None:
            f.seek(0)
            f.write(sec0)
        f.seek(START_LBA * SECTOR)
        f.write(fs)
    return path


def walk(mod, path) -> list[tuple]:
    return [(part, rel, size, opener()) for part, rel, size, opener in mod.walk_disk(str(path))]


def test_walk_equals_jax(disks):
    files = walk(port_vm, disks["ext4"])
    assert files == walk(jax_vm, disks["ext4"])
    by_path = {rel: data for _part, rel, _size, data in files}
    assert by_path["data/big.bin"] == b"A" * 300_000
    want = {p.relative_to(disks["root"]).as_posix(): p.read_bytes()
            for p in disks["root"].rglob("*") if p.is_file()}
    assert by_path == want


def test_unwritten_extent_reads_as_zeros():
    """An extent with ``ee_len`` over 32768 is preallocated, not written:
    it reads as zeros, not the stale bytes at its blocks; 32768 itself is a
    maximal written extent."""
    class Stale:
        def read_at(self, off, n):
            return b"\xde" * n

    node = struct.pack("<HHHH4x", port_vm.EXTENT_MAGIC, 2, 4, 0)
    node += struct.pack("<IHHI", 0, 1, 0, 100) + struct.pack("<IHHI", 1, 0x8001, 0, 101)
    inode = {"size": 2048, "i_block": node, "mode": 0o100644, "flags": 0}
    out = []
    for mod in (port_vm, jax_vm):
        fs = object.__new__(mod.Ext4)
        fs.block_size, fs.r = 1024, Stale()
        out.append(fs.read_file(inode))
        full = struct.pack("<HHHH4x", mod.EXTENT_MAGIC, 1, 4, 0) + struct.pack(
            "<IHHI", 0, 32768, 0, 7)
        assert fs._extents(full) == [(0, 32768, 7, False)]
    assert out[0] == out[1] == b"\xde" * 1024 + b"\x00" * 1024


@pytest.mark.parametrize("kind,name,type_id", [("mbr", "part0", "0x83"),
                                               ("logical", "logical0", "0x83"),
                                               ("gpt", "root", "")])
def test_partitioned_disk(disks, kind, name, type_id):
    parts = []
    for mod in (port_vm, jax_vm):
        with open(disks[kind], "rb") as f:
            reader = mod.SectionReader(f, 0, disks[kind].stat().st_size)
            parts.append([(p.name, p.type_id, p.reader.offset, p.reader.size,
                           mod.detect_filesystem(p)) for p in mod.partitions(reader)])
    assert parts[0] == parts[1] == [(name, type_id, START_LBA * SECTOR, len(disks["fs"]),
                                     "ext4")]
    assert [f[1:] for f in walk(port_vm, disks[kind])] == [
        f[1:] for f in walk(jax_vm, disks["ext4"])]


def run_both(wd: Path, target, *args: str) -> tuple[dict, dict]:
    mine_out, ref_out = wd / "port.json", wd / "jax.json"
    assert cli.main(["vm", "--device", "cpu", "--format", "json", "-o", str(mine_out), "-q",
                     "--cache-dir", str(wd / "c1"), *args, str(target)]) == 0
    assert jax_cli.main(["vm", "--backend", "cpu", "--format", "json", "-o", str(ref_out), "-q",
                         "--cache-dir", str(wd / "c2"), *args, str(target)]) == 0
    return json.loads(mine_out.read_text()), json.loads(ref_out.read_text())


@pytest.mark.parametrize("scanners,extra", [("secret", []),
                                            ("vuln,secret,license", ["--list-all-pkgs"])])
def test_vm_equals_jax(disks, tmp_path, monkeypatch, scanners, extra):
    monkeypatch.chdir(tmp_path)
    mine, jax = run_both(tmp_path, disks["mbr"], "--scanners", scanners,
                         "--db-repository", disks["db"], *extra)
    assert mine["Results"] == jax["Results"] and mine["Metadata"] == jax["Metadata"]
    assert (mine["ArtifactName"], mine["ArtifactType"]) == (str(disks["mbr"]), "vm")
    assert mine["Metadata"]["OS"]["Family"] == "alpine"
    assert any(r.get("Secrets") for r in mine["Results"])
    if "vuln" in scanners:
        assert any(r.get("Vulnerabilities") for r in mine["Results"])
        assert any(r["Class"] == "license-file" for r in mine["Results"])


def test_cache_hit_on_rescan(disks, tmp_path):
    kw = dict(device="cpu", cache=new_cache("fs", str(tmp_path / "c")),
              scanners=("vuln", "secret"), db_repository=disks["db"])
    first, s1 = cli.scan_vm(str(disks["ext4"]), **kw)
    second, s2 = cli.scan_vm(str(disks["ext4"]), **kw)
    assert s1["files_walked"] == len([p for p in disks["root"].rglob("*") if p.is_file()])
    assert s2["files_walked"] == 0 and s2["batches"] == 0 and s1["batches"] > 0
    assert first.to_dict()["Results"] == second.to_dict()["Results"]
    assert first.to_dict()["Metadata"] == second.to_dict()["Metadata"]
    # the same analyzers (every package analyzer runs whatever the
    # scanners) share the blob; without the secret analyzer the key differs
    _same, s3 = cli.scan_vm(str(disks["ext4"]), **{**kw, "scanners": ("secret",)})
    _other, s4 = cli.scan_vm(str(disks["ext4"]), **{**kw, "scanners": ("vuln",)})
    assert (s3["files_walked"], s4["files_walked"]) == (0, s1["files_walked"])
