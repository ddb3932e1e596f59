"""Compiled-binary package analyzers.

- Go binaries: module list from the embedded build info — Go wraps the
  ``go version -m`` blob between two public 16-byte sentinels, so the parse
  needs no object-format support at all (works for ELF/PE/Mach-O alike;
  ref: pkg/dependency/parser/golang/binary/parse.go, which uses
  debug/buildinfo over the same data).
- Rust binaries: `cargo auditable` dependency JSON from the ELF
  ``.dep-v0`` section (zlib-deflated; ref:
  pkg/dependency/parser/rust/binary — rust-audit-info's format), read with
  a minimal pure-Python ELF section walker.
"""

from __future__ import annotations

import json
import re
import struct
import zlib

from trivy_tpu_torch import log
from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerType,
    register_analyzer,
)
from trivy_tpu_torch.fanal.utils import is_binary
from trivy_tpu_torch.types import Application, Package, PkgIdentifier

logger = log.logger("analyzer:binary")

# runtime/debug's module-info delimiters (public constants in the Go
# toolchain; the blob between them is the `go version -m` text)
_GO_INFO_START = bytes.fromhex("3077af0c9274080241e1c107e6d618e6")
_GO_INFO_END = bytes.fromhex("f932433186182072008242104116d8f2")
_GO_BUILDINF = b"\xff Go buildinf:"
_GO_VERSION_RE = re.compile(rb"go(\d+\.\d+(?:\.\d+)?)")

# candidate paths: executables have no extension or known binary suffixes;
# the content sniff does the real gating
_SKIP_EXT = (
    ".txt", ".md", ".json", ".yaml", ".yml", ".xml", ".html", ".css", ".js",
    ".py", ".go", ".rs", ".c", ".h", ".sh", ".jar", ".gz", ".zip", ".tar",
    ".png", ".jpg", ".svg", ".gif", ".pdf", ".lock", ".toml", ".cfg", ".ini",
)


def _binary_candidate(file_path: str, info) -> bool:
    """Cheap name/stat prefilter: executable bit or extension-less name;
    the content sniff in analyze() does the real gating."""
    if info.size < 1024 or file_path.lower().endswith(_SKIP_EXT):
        return False
    executable = bool(getattr(info, "mode", 0) & 0o111)
    return executable or "." not in file_path.rsplit("/", 1)[-1]


def _gopurl(name: str, version: str) -> PkgIdentifier:
    return PkgIdentifier(purl=f"pkg:golang/{name}@{version}")


def parse_go_binary(content: bytes) -> tuple[list[Package], str]:
    """Extract (modules, go_version) from a Go binary's build info."""
    start = content.find(_GO_INFO_START)
    if start < 0:
        return [], ""
    end = content.find(_GO_INFO_END, start)
    if end < 0:
        return [], ""
    blob = content[start + len(_GO_INFO_START) : end].decode("utf-8", "replace")

    go_version = ""
    magic = content.find(_GO_BUILDINF)
    if magic >= 0:
        m = _GO_VERSION_RE.search(content, magic, magic + 64)
        if m:
            go_version = m.group(1).decode()

    pkgs: list[Package] = []
    last_dep_idx: int | None = None
    for line in blob.splitlines():
        parts = line.split("\t")
        if parts[0] == "mod" and len(parts) >= 3:
            # main module: version is usually (devel); keep when meaningful
            version = parts[2]
            if version and version != "(devel)":
                pkgs.append(
                    Package(name=parts[1], version=version.lstrip("v"),
                            identifier=_gopurl(parts[1], version))
                )
        elif parts[0] == "dep" and len(parts) >= 3:
            version = parts[2]
            pkgs.append(
                Package(name=parts[1], version=version.lstrip("v"),
                        identifier=_gopurl(parts[1], version))
            )
            last_dep_idx = len(pkgs) - 1
        elif parts[0] == "=>" and len(parts) >= 3 and last_dep_idx is not None:
            # replace directive overrides the preceding dep
            version = parts[2]
            pkgs[last_dep_idx] = Package(
                name=parts[1], version=version.lstrip("v"),
                identifier=_gopurl(parts[1], version),
            )
    if go_version:
        # the Go standard library is a vulnerable component too (the
        # reference reports it as "stdlib")
        pkgs.append(
            Package(name="stdlib", version=go_version,
                    identifier=_gopurl("stdlib", go_version))
        )
    pkgs.sort(key=lambda p: (p.name, p.version))
    return pkgs, go_version


def _elf_section(content: bytes, wanted: str) -> bytes | None:
    """Minimal ELF section lookup (64- and 32-bit little-endian)."""
    if content[:4] != b"\x7fELF" or len(content) < 64:
        return None
    is64 = content[4] == 2
    little = content[5] == 1
    if not little:
        return None  # big-endian binaries are out of scope
    try:
        if is64:
            e_shoff, = struct.unpack_from("<Q", content, 0x28)
            e_shentsize, = struct.unpack_from("<H", content, 0x3A)
            e_shnum, = struct.unpack_from("<H", content, 0x3C)
            e_shstrndx, = struct.unpack_from("<H", content, 0x3E)
            name_off = 0x0
            off_off, size_off = 0x18, 0x20
        else:
            e_shoff, = struct.unpack_from("<I", content, 0x20)
            e_shentsize, = struct.unpack_from("<H", content, 0x2E)
            e_shnum, = struct.unpack_from("<H", content, 0x30)
            e_shstrndx, = struct.unpack_from("<H", content, 0x32)
            name_off = 0x0
            off_off, size_off = 0x10, 0x14
        if e_shoff == 0 or e_shnum == 0 or e_shstrndx >= e_shnum:
            return None

        def sh(i: int, field_off: int, width: str):
            return struct.unpack_from(
                "<" + width, content, e_shoff + i * e_shentsize + field_off
            )[0]

        w = "Q" if is64 else "I"
        strtab_off = sh(e_shstrndx, off_off, w)
        strtab_size = sh(e_shstrndx, size_off, w)
        strtab = content[strtab_off : strtab_off + strtab_size]
        for i in range(e_shnum):
            noff = sh(i, name_off, "I")
            nend = strtab.find(b"\x00", noff)
            if strtab[noff:nend].decode("latin-1") == wanted:
                off = sh(i, off_off, w)
                size = sh(i, size_off, w)
                return content[off : off + size]
    except (struct.error, IndexError, ValueError):
        return None
    return None


def parse_rust_binary(content: bytes) -> list[Package]:
    """cargo-auditable dependency list from the ELF ``.dep-v0`` section."""
    section = _elf_section(content, ".dep-v0")
    if not section:
        return []
    try:
        doc = json.loads(zlib.decompress(section))
    except (zlib.error, json.JSONDecodeError, ValueError):
        return []
    pkgs = []
    for p in doc.get("packages", []) or []:
        name, version = p.get("name", ""), p.get("version", "")
        if not name or not version:
            continue
        if p.get("root"):
            continue  # the binary itself, not a dependency
        pkgs.append(
            Package(
                name=name,
                version=version,
                dev=p.get("kind") == "build",
                identifier=PkgIdentifier(purl=f"pkg:cargo/{name}@{version}"),
            )
        )
    pkgs.sort(key=lambda p: (p.name, p.version))
    return pkgs


class GoBinaryAnalyzer(Analyzer):
    type = AnalyzerType.GO_BINARY
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return _binary_candidate(file_path, info)

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        if not is_binary(inp.content):
            return None
        pkgs, _ = parse_go_binary(inp.content)
        if not pkgs:
            return None
        return AnalysisResult(
            applications=[
                Application(type="gobinary", file_path=inp.file_path, packages=pkgs)
            ]
        )


class RustBinaryAnalyzer(Analyzer):
    type = AnalyzerType.RUST_BINARY
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return _binary_candidate(file_path, info)

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        if not is_binary(inp.content):
            return None
        pkgs = parse_rust_binary(inp.content)
        if not pkgs:
            return None
        return AnalysisResult(
            applications=[
                Application(type="rust-binary", file_path=inp.file_path, packages=pkgs)
            ]
        )


register_analyzer(GoBinaryAnalyzer)
register_analyzer(RustBinaryAnalyzer)
