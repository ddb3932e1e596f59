"""The port's per-file analyzers against the JAX package's: installed
packages, Go and Rust binaries, the four OS release analyzers, apk, dpkg,
rpm (sqlite, ndb and BerkeleyDB databases, built with the JAX package's
fixture writers), the build-info analyzers and SBOM files, each on the same
bytes; then the analyzer group's order, ``AnalysisResult.merge``/``sort``,
the system-file filter and the layer applier."""

import json

import pytest

from tests.test_installed import GEMSPEC, METADATA, TestGoBinary, go_binary, rust_elf
from tests.test_analyzers import APK_DB, DPKG_STATUS
from tests.test_rpm import ALL as RPM_HEADERS
from trivy_tpu.fanal import analyzer as jax_analyzer
from trivy_tpu.fanal import applier as jax_applier
from trivy_tpu.fanal import handler as jax_handler
from trivy_tpu.fanal import rpmdb as jax_rpmdb
from trivy_tpu.fanal.walker import FileInfo as JaxFileInfo
from trivy_tpu import types as jax_types
from trivy_tpu_torch import types
from trivy_tpu_torch.fanal import analyzer, applier, handler, rpmdb
from trivy_tpu_torch.fanal.walker import FileInfo

CDX = json.dumps({"bomFormat": "CycloneDX", "specVersion": "1.5", "components": [
    {"type": "library", "name": "lodash", "version": "4.17.20",
     "purl": "pkg:npm/lodash@4.17.20"},
    {"type": "library", "name": "openssl", "version": "3.0.11-1~deb12u1",
     "purl": "pkg:deb/debian/openssl@3.0.11-1~deb12u1?distro=debian-12"},
    {"type": "operating-system", "name": "debian", "version": "12"},
]}).encode()

DOCKERFILE = b"""FROM ubi9
ENV NAME=nginx VERSION=1.22
LABEL com.redhat.component="$NAME-container" \\
      architecture="x86_64"
"""

NPM_PKG = json.dumps({"name": "left-pad", "version": "1.3.0", "license": "WTFPL"}).encode()
RPM_SQLITE = jax_rpmdb.build_sqlite_db([f() for f in RPM_HEADERS])

# (type, path, content, mode, extra options): one case per analyzer and input kind
CASES = [
    ("node-pkg", "app/node_modules/left-pad/package.json", NPM_PKG, 0o644, {}),
    ("node-pkg", "node_modules/old/package.json",
     json.dumps({"name": "old", "version": 2, "license": {"type": "ISC"}}).encode(), 0o644, {}),
    ("node-pkg", "node_modules/bad/package.json", b"{", 0o644, {}),
    ("python-pkg", "site/requests-2.31.0.dist-info/METADATA", METADATA.encode(), 0o644, {}),
    ("python-pkg", "site/x.egg-info/PKG-INFO",
     b"Name: x\nVersion: 1\nLicense: UNKNOWN\nClassifier: License :: OSI Approved :: MIT License\n",
     0o644, {}),
    ("gemspec", "gems/specifications/rails-7.0.4.gemspec", GEMSPEC.encode(), 0o644, {}),
    ("conda-pkg", "env/conda-meta/numpy-1.24.3.json",
     json.dumps({"name": "numpy", "version": "1.24.3", "license": "BSD-3-Clause"}).encode(),
     0o644, {}),
    ("gobinary", "usr/local/bin/tool", go_binary(TestGoBinary.MODINFO), 0o755, {}),
    ("gobinary", "bin/plain", b"#!/bin/sh\n" + b"echo hi\n" * 200, 0o755, {}),
    ("rustbinary", "usr/bin/rtool", rust_elf([
        {"name": "serde", "version": "1.0.190"},
        {"name": "tokio", "version": "1.33.0", "kind": "build"},
        {"name": "rtool", "version": "0.1.0", "root": True}]) + b"\x00" * 1024, 0o755, {}),
    ("os-release", "etc/os-release", b'NAME="Ubuntu"\nID=ubuntu\nVERSION_ID="22.04"\n', 0o644, {}),
    ("os-release", "usr/lib/os-release", b"ID=linuxmint\nID_LIKE=ubuntu\nVERSION_ID=21\n",
     0o644, {}),
    ("os-release", "etc/os-release", b"ID=amzn\nVERSION_ID=2018.03\n", 0o644, {}),
    ("alpine", "etc/alpine-release", b"3.18.4\n", 0o644, {}),
    ("debian", "etc/debian_version", b"12.4\n", 0o644, {}),
    ("debian", "etc/debian_version", b"trixie/sid\n", 0o644, {}),
    ("redhat", "etc/redhat-release", b"CentOS Linux release 8.4.2105 (Core)\n", 0o644, {}),
    ("redhat", "etc/system-release", b"Red Hat Enterprise Linux release 9.2 (Plow)\n",
     0o644, {}),
    ("apk", "lib/apk/db/installed", APK_DB, 0o644, {}),
    ("dpkg", "var/lib/dpkg/status", DPKG_STATUS, 0o644, {}),
    ("dpkg", "var/lib/dpkg/status.d/base", DPKG_STATUS, 0o644, {}),
    ("dpkg", "var/lib/dpkg/info/libssl3.list", b"/.\n/usr/lib/libssl.so.3\n", 0o644, {}),
    ("rpm", "var/lib/rpm/rpmdb.sqlite", RPM_SQLITE, 0o644, {}),
    ("rpm", "usr/lib/sysimage/rpm/Packages.db",
     jax_rpmdb.build_ndb([f() for f in RPM_HEADERS]), 0o644, {}),
    ("rpm", "var/lib/rpm/Packages", jax_rpmdb.build_bdb([f() for f in RPM_HEADERS]), 0o644, {}),
    ("rpm", "var/lib/rpm/Packages",
     jax_rpmdb.build_bdb([f() for f in RPM_HEADERS], big_endian=True), 0o644, {}),
    ("rpm", "var/lib/rpm/Packages", b"\0" * 12 + (0x00061561).to_bytes(4, "little") + b"\0" * 64,
     0o644, {}),
    ("redhat-content-manifest", "root/buildinfo/content_manifests/ubi.json",
     json.dumps({"content_sets": ["rhel-9-baseos", "rhel-9-appstream"]}).encode(), 0o644, {}),
    ("redhat-dockerfile", "root/buildinfo/Dockerfile-ubi9-nginx-1.22-15", DOCKERFILE, 0o644, {}),
    ("apk-repo", "etc/apk/repositories",
     b"https://dl-cdn.alpinelinux.org/alpine/v3.18/main\n"
     b"https://dl-cdn.alpinelinux.org/alpine/v3.19/community\n"
     b"# https://dl-cdn.alpinelinux.org/alpine/edge/main\n", 0o644, {}),
    ("executable", "usr/bin/x", b"\x7fELF" + b"\x00" * 2000, 0o755, {"executable_digests": True}),
    ("sbom", "opt/app/bom.json", CDX, 0o644, {}),
    ("sbom", "opt/app/broken.cdx.json", b"{]", 0o644, {}),
]


def shape(r):
    """An analysis result as plain data (None stays None)."""
    if r is None:
        return None
    return {
        "os": r.os and r.os.to_dict(), "repository": r.repository,
        "build_info": r.build_info, "digests": r.digests,
        "package_infos": [pi.to_dict() for pi in r.package_infos],
        "applications": [a.to_dict() for a in r.applications],
        "system_files": r.system_files,
        "secrets": [s.to_dict() for s in r.secrets],
        "licenses": [lf.to_dict() for lf in r.licenses],
    }


def both(t: str, extra: dict):
    import trivy_tpu.fanal.analyzers  # noqa: F401  (registers the JAX analyzers)
    import trivy_tpu_torch.fanal.analyzers  # noqa: F401

    return (analyzer._analyzers[analyzer.AnalyzerType(t)](analyzer.AnalyzerOptions(extra=extra)),
            jax_analyzer._analyzers[jax_analyzer.AnalyzerType(t)](
                jax_analyzer.AnalyzerOptions(extra=extra)))


def run(a, info_cls, inp_cls, path, content, mode, dir_="/x"):
    info = info_cls(size=len(content), mode=mode)
    if not a.required(path, info):
        return "not required"
    return shape(a.analyze(inp_cls(dir=dir_, file_path=path, info=info, content=content)))


@pytest.mark.parametrize("t,path,content,mode,extra", CASES,
                         ids=[f"{c[0]}:{c[1]}:{i}" for i, c in enumerate(CASES)])
def test_analyzer_equals_jax(t, path, content, mode, extra):
    mine, ref = both(t, extra)
    got = run(mine, FileInfo, analyzer.AnalysisInput, path, content, mode)
    want = run(ref, JaxFileInfo, jax_analyzer.AnalysisInput, path, content, mode)
    assert got == want
    assert got != "not required"


@pytest.mark.parametrize("path,size,mode", [
    ("main.go", 9999, 0o644), ("data.json", 9999, 0o755), ("bin/tool", 100, 0o755),
    ("bin/tool", 5000, 0o644), ("lib/x.so.1", 5000, 0o755), ("README", 5000, 0o644),
    ("node_modules/x/package.json", 10, 0o644), ("package.json", 10, 0o644),
    ("etc/os-release", 10, 0o644), ("sub/etc/os-release", 10, 0o644),
    ("big.spdx.json", 17 << 20, 0o644), ("x/sbom.json", 10, 0o644),
    ("var/lib/dpkg/status.d/x.md5sums", 10, 0o644), ("a.egg-info", 10, 0o644),
])
def test_required_equals_jax(path, size, mode):
    import trivy_tpu.fanal.analyzers  # noqa: F401
    import trivy_tpu_torch.fanal.analyzers  # noqa: F401

    for t in analyzer._analyzers:
        mine, ref = both(t.value, {"executable_digests": True})
        assert mine.required(path, FileInfo(size, mode)) == \
            ref.required(path, JaxFileInfo(size, mode)), (t, path)


def test_group_order_equals_jax():
    """The per-file analyzers in the JAX group's order: its batched ones
    (secret, license, config) live beside the port's group."""
    mine = analyzer.AnalyzerGroup()
    ref = jax_analyzer.AnalyzerGroup(jax_analyzer.AnalyzerOptions(
        backend="cpu", disabled=[jax_analyzer.AnalyzerType.SECRET,
                                 jax_analyzer.AnalyzerType.LICENSE_FILE,
                                 jax_analyzer.AnalyzerType.LICENSE_HEADER,
                                 jax_analyzer.AnalyzerType.CONFIG]))
    assert [a.type.value for a in mine.analyzers] == [a.type.value for a in ref.analyzers]
    assert not ref.batch_analyzers and not ref.post_analyzers
    ident = analyzer.AnalyzerGroup(analyzer.AnalyzerOptions(enabled=analyzer.OS_IDENTITY))
    assert [a.type.value for a in ident.analyzers] == \
        ["alpine", "debian", "os-release", "redhat", "sbom"]


def merged(mod, info_cls, inp_cls, reg):
    """Every case's result merged into one, in reverse order, then sorted."""
    total = mod.AnalysisResult()
    for t, path, content, mode, extra in reversed(CASES):
        a = reg[mod.AnalyzerType(t)](mod.AnalyzerOptions(extra=extra))
        info = info_cls(size=len(content), mode=mode)
        total.merge(a.analyze(inp_cls(dir="/x", file_path=path, info=info, content=content)))
    return total


def test_merge_sort_blob_equal():
    import trivy_tpu.fanal.analyzers  # noqa: F401
    import trivy_tpu_torch.fanal.analyzers  # noqa: F401

    mine = merged(analyzer, FileInfo, analyzer.AnalysisInput, analyzer._analyzers)
    ref = merged(jax_analyzer, JaxFileInfo, jax_analyzer.AnalysisInput, jax_analyzer._analyzers)
    assert shape(mine) == shape(ref)
    mine_blob, ref_blob = mine.to_blob_info(), ref.to_blob_info()
    assert shape(mine) == shape(ref)  # sorted in place
    assert [pi.file_path for pi in mine_blob.package_infos] == sorted(
        pi.file_path for pi in mine_blob.package_infos)
    # the system-file filter and the applier on the merged blob
    handler.HandlerManager().post_handle(mine, mine_blob)
    jax_handler.HandlerManager().post_handle(ref, ref_blob)
    d_mine, d_ref = applier.apply_layers([mine_blob]), jax_applier.apply_layers([ref_blob])
    assert d_mine.os.to_dict() == d_ref.os.to_dict()
    assert (d_mine.repository, d_mine.build_info, d_mine.digests) == \
        (d_ref.repository, d_ref.build_info, d_ref.digests)
    assert [p.to_dict() for p in d_mine.packages] == [p.to_dict() for p in d_ref.packages]
    assert [a.to_dict() for a in d_mine.applications] == \
        [a.to_dict() for a in d_ref.applications]
    assert len(d_mine.packages) > 10 and len(d_mine.applications) > 5


def _layers(mod):
    Pkg, PI, App, Sec, SF, LF = (mod.Package, mod.PackageInfo, mod.Application, mod.Secret,
                                 mod.SecretFinding, mod.LicenseFile)

    def finding():
        return SF(rule_id="r", category="c", severity="HIGH", title="t", start_line=1,
                  end_line=1, match="m")

    lower = mod.BlobInfo(
        diff_id="sha256:a", os=mod.OS(family="alpine", name="3.18"),
        package_infos=[PI(file_path="lib/apk/db/installed", packages=[Pkg("musl", "1")]),
                       PI(file_path="image history (apk commands)",
                          packages=[Pkg("musl", "0")])],
        applications=[App(type="npm", file_path="app/package-lock.json",
                          packages=[Pkg("a", "1")]),
                      App(type="pip", file_path="old/requirements.txt",
                          packages=[Pkg("b", "1")])],
        secrets=[Sec(file_path="/old/key.txt", findings=[finding()]),
                 Sec(file_path="/keep.txt", findings=[finding()])],
        licenses=[LF(type="license-file", file_path="old/LICENSE")])
    upper = mod.BlobInfo(
        diff_id="sha256:b", os=mod.OS(name="3.19"), repository={"Family": "alpine"},
        whiteout_files=["old/key.txt"], opaque_dirs=["old/"],
        applications=[App(type="npm", file_path="app/package-lock.json",
                          packages=[Pkg("a", "2")])])
    return [lower, upper]


def test_apply_layers_equals_jax():
    mine = applier.apply_layers(_layers(types))
    ref = jax_applier.apply_layers(_layers(jax_types))
    assert mine.os.to_dict() == ref.os.to_dict() == \
        {"Family": "alpine", "Name": "3.19", "Eosl": False, "Extended": False}
    assert mine.repository == ref.repository
    assert [p.to_dict() for p in mine.packages] == [p.to_dict() for p in ref.packages]
    assert [a.to_dict() for a in mine.applications] == [a.to_dict() for a in ref.applications]
    assert [s.to_dict() for s in mine.secrets] == [s.to_dict() for s in ref.secrets]
    assert [lf.to_dict() for lf in mine.licenses] == [lf.to_dict() for lf in ref.licenses]
    # the real DB supersedes the apk history list; the whiteouts deleted
    assert [p.version for p in mine.packages] == ["1"]
    assert [s.file_path for s in mine.secrets] == ["/keep.txt"] and not mine.licenses
    assert [a.packages[0].layer for a in mine.applications] == ["sha256:b"]


def test_rpm_read_side_equals_jax():
    for build in (jax_rpmdb.build_sqlite_db, jax_rpmdb.build_ndb, jax_rpmdb.build_bdb):
        content = build([f() for f in RPM_HEADERS])
        assert rpmdb.detect_format(content) == jax_rpmdb.detect_format(content)
        got, want = rpmdb.read_headers(content), jax_rpmdb.read_headers(content)
        assert [h.tags for h in got] == [h.tags for h in want] and len(got) == 4
    with pytest.raises(rpmdb.RpmDBError):
        rpmdb.read_headers(b"not a database")
