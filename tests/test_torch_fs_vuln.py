"""``fs --scanners vuln`` of the port against the JAX package's CLI, both run
in-process in one working directory (a fresh tmp dir, so no stray ignore or
config file leaks in): trees that hold every lockfile kind, installed
packages, Go and Rust binaries, a jar with a Java DB, a ``pom.xml`` parent
chain and an OS root (alpine, debian, or rpm in each DB format), scanned
against ``tests/dbtest.py``'s DB under every scanner set, with
``--list-all-pkgs`` and without a DB. ``Results`` and ``Metadata`` must be
equal; no float is on this path, so the comparison is exact."""

import json
from pathlib import Path

import pytest

from tests.dbtest import build_db
from tests.secret_samples import SAMPLES
from tests.test_analyzers import APK_DB, DPKG_STATUS
from tests.test_installed import METADATA, TestGoBinary, go_binary, rust_elf
from tests.test_rpm import ALL as RPM_HEADERS
from tests.test_torch_lockfiles import JAR, LOCKFILES, write_java_db, write_pom_chain
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu.fanal import rpmdb as jax_rpmdb
from trivy_tpu_torch import cli
from trivy_tpu_torch.db import VulnDB

OS_ROOTS = {
    "alpine": {"etc/alpine-release": b"3.18.4\n", "lib/apk/db/installed": APK_DB},
    "debian": {"etc/os-release": b'ID=debian\nVERSION_ID="12"\n',
               "var/lib/dpkg/status": DPKG_STATUS,
               "var/lib/dpkg/info/libssl3.list": b"/.\n/usr/lib/libssl.so.3\n"},
    "rpm-sqlite": {"etc/redhat-release": b"Red Hat Enterprise Linux release 9.2 (Plow)\n",
                   "var/lib/rpm/rpmdb.sqlite":
                       jax_rpmdb.build_sqlite_db([f() for f in RPM_HEADERS])},
    "rpm-ndb": {"etc/redhat-release": b"Red Hat Enterprise Linux release 9.2 (Plow)\n",
                "usr/lib/sysimage/rpm/Packages.db":
                    jax_rpmdb.build_ndb([f() for f in RPM_HEADERS])},
    "rpm-bdb": {"etc/redhat-release": b"Red Hat Enterprise Linux release 9.2 (Plow)\n",
                "var/lib/rpm/Packages": jax_rpmdb.build_bdb([f() for f in RPM_HEADERS])},
}


def write(root: Path, rel: str, content: bytes, mode: int = 0o644) -> None:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(content)
    p.chmod(mode)


def make_tree(root: Path, os_root: str = "alpine") -> None:
    """Every lockfile kind, installed packages with licenses, binaries, a
    jar, a pom chain, an OS root, a secret and a license file."""
    for rel, _parser, content in LOCKFILES:
        write(root, rel, content)
    for name, ver, lic in (("lodash", "4.17.15", "MIT"), ("minimist", "1.2.0", "MIT"),
                           ("left-pad", "1.3.0", "WTFPL")):
        write(root, f"web/node_modules/{name}/package.json",
              json.dumps({"name": name, "version": ver, "license": lic}).encode())
    write(root, "site/requests-2.31.0.dist-info/METADATA", METADATA.encode())
    write(root, "site/Django-4.0.1.dist-info/METADATA",
          b"Metadata-Version: 2.1\nName: Django\nVersion: 4.0.1\nLicense: BSD-3-Clause\n")
    write(root, "usr/local/bin/tool", go_binary(TestGoBinary.MODINFO), 0o755)
    write(root, "usr/bin/rtool", rust_elf([{"name": "serde", "version": "1.0.190"}])
          + b"\x00" * 1024, 0o755)
    write(root, "app/log4j.jar", JAR)
    write(root, "app/lib/guava-31.1-jre.jar", b"PK\x03\x04junk")
    write_pom_chain(root)
    for rel, content in OS_ROOTS[os_root].items():
        write(root, rel, content)
    write(root, "src/config.py", f"key = '{SAMPLES['github-pat']}'\n".encode())
    write(root, "LICENSE", b"MIT License\n\nPermission is hereby granted, free of charge, "
          b"to any person obtaining a copy of this software.\n")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("fsvuln")
    out = {}
    for os_root in OS_ROOTS:
        make_tree(base / os_root, os_root)
        out[os_root] = base / os_root
    write_java_db(base / "javadb")
    out["db"] = build_db(base)
    out["javadb"] = str(base / "javadb")
    return out


def run_both(wd: Path, target, *args) -> tuple[dict, dict, int, int]:
    """Both CLIs on ``target`` from the working directory ``wd``: the
    port's JSON, the JAX package's and both exit codes."""
    mine_out, ref_out = wd / "port.json", wd / "jax.json"
    rc_mine = cli.main(["fs", "--device", "cpu", "--format", "json", "-o", str(mine_out),
                        "-q", "--cache-dir", str(wd / "c1"), *args, str(target)])
    rc_ref = jax_cli.main(["fs", "--backend", "cpu", "--format", "json", "-o", str(ref_out),
                           "-q", "--cache-dir", str(wd / "c2"), *args, str(target)])
    return json.loads(mine_out.read_text()), json.loads(ref_out.read_text()), rc_mine, rc_ref


@pytest.fixture
def wd(tmp_path, monkeypatch):
    d = tmp_path / "wd"
    d.mkdir()
    monkeypatch.chdir(d)
    return d


def assert_equal(mine, ref):
    assert mine["Results"] == ref["Results"]
    assert mine["Metadata"] == ref["Metadata"]
    assert (mine["ArtifactName"], mine["ArtifactType"]) == (ref["ArtifactName"],
                                                            ref["ArtifactType"])


SCANNER_SETS = [
    ("vuln", []), ("vuln,secret", []), ("vuln,license", []), ("license", []),
    ("secret", []), ("vuln", ["--list-all-pkgs"]), ("secret,license", ["--list-all-pkgs"]),
]


@pytest.mark.parametrize("scanners,extra", SCANNER_SETS,
                         ids=[s + "".join(e) for s, e in SCANNER_SETS])
def test_fs_equals_jax(trees, wd, scanners, extra):
    mine, ref, rc1, rc2 = run_both(wd, trees["alpine"], "--scanners", scanners,
                                   "--db-repository", trees["db"],
                                   "--java-db", trees["javadb"], *extra)
    assert rc1 == rc2 == 0
    assert_equal(mine, ref)
    classes = {r["Class"] for r in mine["Results"]}
    assert mine["Metadata"]["OS"]["Family"] == "alpine"  # under every scanner set
    if "vuln" in scanners:
        found = {v["VulnerabilityID"] for r in mine["Results"]
                 for v in r.get("Vulnerabilities", [])}
        assert {"CVE-2021-23337", "CVE-2020-7598", "CVE-2023-2222", "CVE-2023-0003"} <= found
        assert {"os-pkgs", "lang-pkgs"} <= classes
    if "license" in scanners:
        targets = {r["Target"] for r in mine["Results"] if r["Class"] == "license"}
        assert targets == {"OS Packages", "Language Packages"}
    if "--list-all-pkgs" in extra:
        assert any(r.get("Packages") for r in mine["Results"])
    assert ("secret" in classes) == ("secret" in scanners)


@pytest.mark.parametrize("os_root", sorted(OS_ROOTS))
def test_fs_os_roots_equal_jax(trees, wd, os_root):
    mine, ref, _rc1, _rc2 = run_both(wd, trees[os_root], "--scanners", "vuln",
                                     "--db-repository", trees["db"], "--list-all-pkgs")
    assert_equal(mine, ref)
    os_pkgs = [r for r in mine["Results"] if r["Class"] == "os-pkgs"]
    assert len(os_pkgs) == 1 and os_pkgs[0]["Packages"]


@pytest.mark.parametrize("extra", [[], ["--list-all-pkgs"]], ids=["plain", "list-all-pkgs"])
def test_fs_without_db_equals_jax(trees, wd, extra, caplog):
    mine, ref, _rc1, _rc2 = run_both(wd, trees["alpine"], "--scanners", "vuln", *extra)
    assert_equal(mine, ref)
    assert bool(mine["Results"]) == bool(extra)
    assert not any(r.get("Vulnerabilities") for r in mine["Results"])


def test_scan_fs_one_db_many_scans(trees):
    """``scan_fs`` with a loaded DB: one detection dispatch per scan, the
    bound matrix uploaded once, the same report twice."""
    db = VulnDB.load(trees["db"])
    first, s1 = cli.scan_fs(str(trees["alpine"]), scanners=("vuln",), db=db, device="cpu")
    second, s2 = cli.scan_fs(str(trees["alpine"]), scanners=("vuln",), db=db, device="cpu")
    assert first.to_dict()["Results"] == second.to_dict()["Results"]
    assert "db_load_seconds" not in s1 and s1["components"] > 60
    assert s1["detect.seconds"] > 0 and s1["analyze.seconds"] > 0
    for key in cli.CVE_COUNTERS:
        assert key in s1 and key in s2


def test_scan_fs_secret_only_skips_package_analyzers(trees, monkeypatch):
    """A secret-only scan reads no lockfile, binary or package DB: only the
    OS identity analyzers and the secret analyzer take files."""
    from trivy_tpu_torch.fanal.analyzers import binary, lang

    def boom(*_a, **_k):
        raise AssertionError("a package analyzer ran in a secret-only scan")

    monkeypatch.setattr(binary.GoBinaryAnalyzer, "analyze", boom)
    monkeypatch.setattr(lang.PomAnalyzer, "analyze", boom)
    report, stats = cli.scan_fs(str(trees["alpine"]), scanners=("secret",), device="cpu")
    assert report.metadata["OS"]["Family"] == "alpine" and stats["components"] == 0
