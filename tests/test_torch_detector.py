"""The port's vulnerability detection against the JAX package: the
resident CVE join (``detect_batch``), per-application ``detect``, OS
package detection and the detail fill, on the fixture DB and on a seeded
synthetic DB; the join's arrays and upload counters; a device error
failing the scan; and the DB loaders on eager, lazy and ``trivy.db`` DBs.
The findings' ``to_dict()`` lists must be equal, in order."""

import json
import os
import random
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from tests.dbtest import build_db
from tests.test_boltdb import build_bolt
from trivy_tpu import obs
from trivy_tpu.db import VulnDB as JaxVulnDB
from trivy_tpu.db import load_default_db as jax_load_default_db
from trivy_tpu.db.convert import convert_bolt as jax_convert_bolt
from trivy_tpu.detector import library as jax_library
from trivy_tpu.detector import ospkg as jax_ospkg
from trivy_tpu.types import OS as JaxOS
from trivy_tpu.types import Application as JaxApplication
from trivy_tpu.types import Package as JaxPackage
from trivy_tpu.vulnerability import fill_infos as jax_fill_infos
from trivy_tpu_torch import obs as tobs
from trivy_tpu_torch.db import VulnDB, load_default_db
from trivy_tpu_torch.db.convert import convert_bolt
from trivy_tpu_torch.detector import library, ospkg
from trivy_tpu_torch.ops import verscmp
from trivy_tpu_torch.types import OS, Application, Package
from trivy_tpu_torch.vulnerability import fill_infos

# (app type, bucket prefix, package names) of the synthetic DB
ECOS = {
    "npm": ("npm", [f"js-{i}" for i in range(40)]),
    "gomod": ("go", [f"github.com/o/m{i}" for i in range(25)]),
    "cargo": ("cargo", [f"crate{i}" for i in range(20)]),
    "composer": ("composer", [f"v/p{i}" for i in range(10)]),
    "pip": ("pip", [f"py-pkg{i}" for i in range(15)]),
    "jar": ("maven", [f"org.x:art{i}" for i in range(15)]),
    "bundler": ("rubygems", [f"gem{i}" for i in range(10)]),
}
JOIN_ARRAYS = ("bounds", "row_pad", "ops_flat", "b_flat", "glocal_flat", "slot_base",
               "slot_count", "adv_start", "adv_len", "adv_groups", "adv_host",
               "_hash_sorted", "_slot_order", "_key_mat", "_key_len")


def version(rng: random.Random, scheme: str) -> str:
    v = f"{rng.randint(0, 4)}.{rng.randint(0, 9)}.{rng.randint(0, 12)}"
    if rng.random() < 0.2:
        v += {"pep440": rng.choice(["a1", "rc2", ".post1"]),
              "maven": rng.choice(["-SNAPSHOT", "-RC1", ".Final"]),
              "gem": rng.choice([".pre", ".rc1"])}.get(
                  scheme, rng.choice(["-alpha", "-beta.2", "-rc.1", "-0"]))
    return v


def advisory(rng: random.Random, scheme: str, vid: str) -> dict:
    """One library advisory: ranges (with prereleases, caret and tilde
    terms, OR-ed entries), patched-only, an empty group, an entry no term
    of which parses, or no constraint at all."""
    a, b = sorted([version(rng, scheme), version(rng, scheme)])
    kind = rng.random()
    d: dict = {"VulnerabilityID": vid}
    if kind < 0.45:
        d["VulnerableVersions"] = [f">={a}, <{b}"] + ([f"<{version(rng, scheme)}"]
                                                      if rng.random() < 0.4 else [])
        d["PatchedVersions"] = [b]
    elif kind < 0.6:
        d["VulnerableVersions"] = [rng.choice([f"^{a}", f"~{a}", f"<={a}", f"={a}",
                                               f"<{a}-rc.1", f"!={a}"])]
    elif kind < 0.75:
        d["PatchedVersions"] = [b] + ([f">={version(rng, scheme)}"] if rng.random() < 0.5 else [])
    elif kind < 0.8:
        d["FixedVersion"] = f"{b}, {version(rng, scheme)}"
    elif kind < 0.85:
        d["VulnerableVersions"] = ["*"]  # one empty group: every version
    elif kind < 0.9:
        d["VulnerableVersions"] = ["garbage ~~ 1", f"<{a}"]
    elif kind < 0.95:
        d["VulnerableVersions"] = [f">{a} || <0.1.0"]
    if rng.random() < 0.5:
        d["Severity"] = rng.choice(["LOW", "MEDIUM", "HIGH", "CRITICAL"])
    return d


def synthetic_db(root: Path, seed: int = 1) -> str:
    """A seeded flattened DB: two sources per ecosystem, a debian 12 bucket,
    details (with and without severity) for about half the IDs."""
    rng = random.Random(seed)
    schemes = {"pip": "pep440", "maven": "maven", "rubygems": "gem"}
    adv: dict = {}
    details: dict = {}
    n = 0
    for _app, (prefix, names) in ECOS.items():
        for source in ("ghsa", "osv"):
            bucket = adv.setdefault(f"{prefix}::{source}", {})
            for name in names:
                if rng.random() < 0.3:
                    continue
                rows = []
                for _ in range(rng.randint(1, 3)):
                    n += 1
                    vid = f"CVE-2024-{n:05d}" if rng.random() < 0.7 else f"GHSA-{n:04d}"
                    rows.append(advisory(rng, schemes.get(prefix, "semver"), vid))
                    if rng.random() < 0.5:
                        details[vid] = {
                            "Title": f"bug {n}", "Description": "d",
                            "CweIDs": ["CWE-79"], "References": [f"https://x/{n}"],
                            **({"Severity": "HIGH"} if rng.random() < 0.5 else
                               {"VendorSeverity": {"ghsa": rng.randint(0, 4)}}),
                        }
                bucket[name] = rows
    deb = adv.setdefault("debian 12", {})
    for i in range(30):
        deb[f"lib{i}"] = [{"VulnerabilityID": f"CVE-2023-{i:05d}",
                           "FixedVersion": f"1.{i % 5}.{i}-{i % 3}"}]
        if i % 4 == 0:
            deb[f"lib{i}"].append({"VulnerabilityID": f"CVE-2022-{i:05d}",
                                   "Status": "affected"})
        details[f"CVE-2023-{i:05d}"] = {"Title": f"lib{i} bug",
                                        "VendorSeverity": {"debian": 1 + i % 3}}
    d = root / "db"
    d.mkdir(parents=True)
    (d / "metadata.json").write_text(json.dumps({"Version": 2}))
    (d / "advisories.json").write_text(json.dumps(adv))
    (d / "vulnerability.json").write_text(json.dumps(details))
    return str(d)


def synthetic_apps(per_app: int, seed: int = 2) -> list[tuple]:
    """(type, file path, [(name, version)]) per application: every
    ecosystem of the synthetic DB, names outside the DB, duplicate
    packages, packages without a version, and one unsupported type."""
    rng = random.Random(seed)
    schemes = {"pip": "pep440", "jar": "maven", "bundler": "gem"}
    apps = []
    for app_type, (_prefix, names) in ECOS.items():
        pkgs = []
        for _ in range(per_app):
            name = rng.choice(names + ["not-in-db"])
            pkgs.append((name, version(rng, schemes.get(app_type, "semver"))))
        pkgs += pkgs[:3] + [(names[0], "")]  # duplicates and a versionless package
        apps.append((app_type, f"{app_type}/lock", pkgs))
    apps.append(("obscure-eco", "x", [("z", "1.0")]))
    return apps


def build_apps(spec, app_cls, pkg_cls):
    return [app_cls(type=t, file_path=fp, packages=[
        pkg_cls(name=n, version=v, id=f"{n}@{v}") for n, v in pkgs]) for t, fp, pkgs in spec]


def dicts(vuln_lists):
    return [[v.to_dict() for v in vulns] for vulns in vuln_lists]


@pytest.fixture
def dbs(tmp_path, request):
    path = build_db(tmp_path) if request.param == "fixture" else synthetic_db(tmp_path)
    return VulnDB.load(path), JaxVulnDB.load(path)


def fixture_apps(per_app: int):
    rng = random.Random(9)
    npm = [(rng.choice(["lodash", "minimist", "other"]),
            f"{rng.randint(0, 4)}.{rng.randint(0, 20)}.{rng.randint(0, 25)}")
           for _ in range(per_app)]
    pip = [(rng.choice(["django", "Django", "flask"]),
            f"{rng.randint(3, 5)}.{rng.randint(0, 2)}.{rng.randint(0, 9)}")
           for _ in range(per_app)]
    return [("npm", "app/package-lock.json", npm + npm[:2]), ("pip", "req.txt", pip)]


def sbom_apps(kind: str, size: str):
    per_app = {"small": 8, "large": 300}[size]
    if kind == "fixture":
        return fixture_apps(per_app if size == "small" else 700)
    return synthetic_apps(per_app)


@pytest.mark.parametrize("dbs", ["fixture", "synthetic"], indirect=True)
@pytest.mark.parametrize("size", ["small", "large"])
def test_detect_batch_equals_jax(dbs, size, request):
    port_db, jax_db = dbs
    kind = request.node.callspec.params["dbs"]
    spec = sbom_apps(kind, size)
    total = sum(len(p) for _t, _f, p in spec)
    assert (total >= library.BATCH_THRESHOLD) == (size == "large")
    stats = Counter()
    got = library.detect_batch(port_db, build_apps(spec, Application, Package), "cpu", stats)
    want = jax_library.detect_batch(jax_db, build_apps(spec, JaxApplication, JaxPackage))
    assert dicts(got) == dicts(want)
    assert sum(map(len, got)) > 0
    if size == "large":
        assert port_db._lib_resident.dispatch_count == jax_db._lib_resident.dispatch_count == 1
        assert stats["cve.dispatch_count"] == 1 and stats["cve.resident_rows"] > 0
        assert stats["cve.candidate_pairs"] >= stats["cve.dispatch_count"]
    else:
        assert getattr(port_db, "_lib_resident", None) is None
    # the detail fill on the same findings
    for g, w in zip(got, want):
        fill_infos(port_db, g)
        jax_fill_infos(jax_db, w)
    assert dicts(got) == dicts(want)


@pytest.mark.parametrize("dbs", ["fixture", "synthetic"], indirect=True)
def test_detect_per_app_equals_jax(dbs, request, monkeypatch):
    """``detect`` on each application, on its compiled-prefix device path
    (above BATCH_THRESHOLD) and on the host path."""
    port_db, jax_db = dbs
    spec = sbom_apps(request.node.callspec.params["dbs"], "large")
    spec = [(t, f, p * (1 + library.BATCH_THRESHOLD // max(len(p), 1))) for t, f, p in spec]
    port_apps = build_apps(spec, Application, Package)
    jax_apps = build_apps(spec, JaxApplication, JaxPackage)
    device_path = [library.detect(port_db, a, "cpu") for a in port_apps]
    assert dicts(device_path) == dicts([jax_library.detect(jax_db, a) for a in jax_apps])
    monkeypatch.setattr(library, "BATCH_THRESHOLD", 10**9)
    monkeypatch.setattr(jax_library, "BATCH_THRESHOLD", 10**9)
    host_path = [library.detect(port_db, a, "cpu") for a in port_apps]
    assert dicts(host_path) == dicts([jax_library.detect(jax_db, a) for a in jax_apps])
    assert dicts(host_path) == dicts(device_path)


@pytest.mark.parametrize("dbs", ["fixture", "synthetic"], indirect=True)
def test_batch_verdicts_without_prefix_index_equal_jax(dbs, request):
    """``_batch_verdicts``, the path of a DB without a merged prefix index:
    one check of every candidate's constraint rows."""
    port_db, jax_db = dbs
    for app_type, _f, pkgs in sbom_apps(request.node.callspec.params["dbs"], "large"):
        eco = library.ECOSYSTEMS.get(app_type)
        if eco is None:
            continue
        prefix, scheme = eco
        cands = [(Package(name=n, version=v), a) for n, v in pkgs if v
                 for a in port_db.prefix_advisories(f"{prefix}::").get(n, ())]
        jcands = [(JaxPackage(name=n, version=v), a) for n, v in pkgs if v
                  for a in jax_db.prefix_advisories(f"{prefix}::").get(n, ())]
        assert (library._batch_verdicts(scheme, cands, "cpu")
                == jax_library._batch_verdicts(scheme, jcands))


@pytest.mark.parametrize("dbs", ["fixture", "synthetic"], indirect=True)
def test_ospkg_detect_equals_jax(dbs):
    port_db, jax_db = dbs
    rng = random.Random(3)
    cases = [("debian", "12", [(f"lib{i}", f"1.{rng.randint(0, 5)}.{i}", str(i % 4), i % 2)
                               for i in range(40)]),
             ("debian", "12.4", [("openssl", "3.0.9", "1", 0), ("openssl", "3.0.11", "1", 0)]),
             ("alpine", "3.18.4", [("musl", "1.2.3", "r0", 0), ("busybox", "1.36.1", "r2", 0)]),
             ("redhat", "9.2", [("bash", "5.1.8", "6.el9", 0), ("openssl", "3.0.7", "20.el9", 1)]),
             ("wolfi", "", [("git", "2.39.0", "r0", 0)]), ("plan9", "4", [("x", "1", "", 0)])]
    for family, name, pkgs in cases:
        mk = [dict(name=n, version=v, release=r, epoch=e, src_name=n + "-src" if e else "")
              for n, v, r, e in pkgs]
        got = ospkg.detect(port_db, OS(family=family, name=name), [Package(**k) for k in mk])
        want = jax_ospkg.detect(jax_db, JaxOS(family=family, name=name),
                                [JaxPackage(**k) for k in mk])
        fill_infos(port_db, got)
        jax_fill_infos(jax_db, want)
        assert [v.to_dict() for v in got] == [v.to_dict() for v in want], family


@pytest.mark.parametrize("dbs", ["synthetic"], indirect=True)
def test_resident_join_state_and_uploads_equal_jax(dbs):
    """The compiled join's arrays equal the JAX join's; a second scan uploads
    no bound bytes; a wider installed version re-uploads once; the upload
    counters equal the JAX package's."""
    port_db, jax_db = dbs
    spec = synthetic_apps(300)
    counts = []
    for scan in range(2):
        stats = Counter()
        library.detect_batch(port_db, build_apps(spec, Application, Package), "cpu", stats)
        with obs.scan_context(name=f"scan{scan}", enabled=True) as ctx:
            jax_library.detect_batch(jax_db, build_apps(spec, JaxApplication, JaxPackage))
            jax_up = ctx.counters.get("cve.bounds_bytes_uploaded", 0)
        counts.append((stats.get("cve.bounds_bytes_uploaded", 0), jax_up))
    rj, jrj = port_db._lib_resident, jax_db._lib_resident
    for name in JOIN_ARRAYS:
        np.testing.assert_array_equal(getattr(rj, name), getattr(jrj, name), err_msg=name)
        assert getattr(rj, name).dtype == getattr(jrj, name).dtype, name
    assert ([(p, n, [vars(a) for a in advs]) for p, n, advs in rj._slots]
            == [(p, n, [vars(a) for a in advs]) for p, n, advs in jrj._slots])
    assert counts[0][0] == counts[0][1] == rj.bounds.nbytes > 0
    assert counts[1] == (0, 0)
    assert rj.upload_bytes == jrj.upload_bytes == rj.bounds.nbytes
    # a prerelease wider than every bound: one re-upload at the wider width
    wide = [("npm", "w/lock", [("js-1", "1.0.0-" + ".".join(["a"] * 40))] + spec[0][2] * 2)]
    stats = Counter()
    got = library.detect_batch(port_db, build_apps(wide, Application, Package), "cpu", stats)
    with obs.scan_context(name="wide", enabled=True) as ctx:
        want = jax_library.detect_batch(jax_db, build_apps(wide, JaxApplication, JaxPackage))
        jax_up = ctx.counters.get("cve.bounds_bytes_uploaded", 0)
    assert dicts(got) == dicts(want)
    assert stats["cve.bounds_bytes_uploaded"] == jax_up > rj.bounds.nbytes
    assert rj.upload_bytes == jrj.upload_bytes
    width, resident = rj._bounds_dev
    assert resident.shape == (rj.bounds.shape[0], width) and width > rj.bounds.shape[1]
    # each row is padded with its own scheme's pad value
    np.testing.assert_array_equal(resident[:, -1].numpy(), rj.row_pad)
    stats = Counter()
    library.detect_batch(port_db, build_apps(spec, Application, Package), "cpu", stats)
    assert stats["cve.bounds_bytes_uploaded"] == 0


@pytest.mark.parametrize("host_fallback", [False, True], ids=["no-fallback", "fallback"])
@pytest.mark.parametrize("dbs", ["fixture"], indirect=True)
def test_device_error_fails_the_scan(dbs, monkeypatch, host_fallback):
    """A device error in the join fails the scan with the fallback off; on,
    every candidate pair is judged by the host comparator (the JAX
    package's ``detect_batch``), the findings equal the card-free join's,
    and the degrade is counted and marks the scan degraded."""
    port_db, jax_db = dbs
    spec = fixture_apps(700)
    want = dicts(library.detect_batch(port_db, build_apps(spec, Application, Package), "cpu"))
    assert want == dicts(jax_library.detect_batch(jax_db, build_apps(spec, JaxApplication,
                                                                      JaxPackage)))

    def broken(*_a, **_k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(verscmp, "check_ops_gather_bucketed", broken)
    stats = Counter()
    with tobs.scan_context(name="cve") as ctx:
        if not host_fallback:
            with pytest.raises(RuntimeError, match="device lost"):
                library.detect_batch(port_db, build_apps(spec, Application, Package), "cpu",
                                     stats, host_fallback=False)
            assert not ctx.health_snapshot()
            return
        got = library.detect_batch(port_db, build_apps(spec, Application, Package), "cpu", stats)
        health = ctx.health_snapshot()
    assert dicts(got) == want and any(want)
    assert stats["cve.degraded"] == 1 and stats["cve.dispatch_count"] == 1
    assert health == {"cve.degraded": 1, "scan.degraded": 1}


def same_db(port_db, jax_db, probes) -> None:
    """Equal buckets, advisories and details for every (bucket, package)
    and ID of ``probes``, and equal merged prefix indexes."""
    for bucket, names in probes.items():
        for name in names:
            assert ([vars(a) for a in port_db.get_advisories(bucket, name)]
                    == [vars(a) for a in jax_db.get_advisories(bucket, name)]), (bucket, name)
        for a in jax_db.get_advisories(bucket, names[0]):
            assert port_db.get_detail(a.vulnerability_id) == jax_db.get_detail(a.vulnerability_id)
    for prefix in ("npm::", "pip::"):
        assert port_db.buckets_with_prefix(prefix) == jax_db.buckets_with_prefix(prefix)
        assert ({k: [vars(a) for a in v] for k, v in port_db.prefix_advisories(prefix).items()}
                == {k: [vars(a) for a in v] for k, v in jax_db.prefix_advisories(prefix).items()})
    assert port_db.metadata == jax_db.metadata


PROBES = {"alpine 3.18": ["musl", "busybox"], "debian 12": ["bash", "openssl"],
          "npm::GitHub Security Advisory Npm": ["lodash"],
          "pip::GitHub Security Advisory Pip": ["django"]}


def test_db_loaders_equal_jax(tmp_path):
    # eager: the fixture DB
    path = build_db(tmp_path / "eager")
    same_db(VulnDB.load(path), JaxVulnDB.load(path),
            {"alpine 3.18": ["musl", "busybox"], "debian 12": ["openssl"],
             "npm::GitHub Security Advisory npm": ["lodash", "minimist"]})
    # lazy: a manifest DB flattened from a bolt file, by either converter
    bolt = tmp_path / "trivy.db"
    build_bolt(str(bolt))
    convert_bolt(str(bolt), str(tmp_path / "lazy"))
    jax_convert_bolt(str(bolt), str(tmp_path / "lazy-jax"))
    for a, b in (("lazy", "lazy"), ("lazy", "lazy-jax")):
        port_db, jax_db = VulnDB.load(str(tmp_path / a)), JaxVulnDB.load(str(tmp_path / b))
        assert port_db._manifest and port_db._detail_shards
        same_db(port_db, jax_db, PROBES)
    for rel in ("manifest.json", "data-sources.json"):
        assert ((tmp_path / "lazy" / rel).read_text()
                == (tmp_path / "lazy-jax" / rel).read_text())
    # load_default_db: --db-repository, then <cache>/db, a trivy.db flattened on first use
    for name in ("repo", "cache/db"):
        (tmp_path / name).mkdir(parents=True)
        build_bolt(str(tmp_path / name / "trivy.db"))
    port_db = load_default_db(str(tmp_path / "repo"), None)
    assert port_db.db_dir == str(tmp_path / "repo" / "flattened")
    jax_db = jax_load_default_db(str(tmp_path / "repo"), None)
    same_db(port_db, jax_db, PROBES)
    port_db = load_default_db(None, str(tmp_path / "cache"))
    assert port_db.db_dir == str(tmp_path / "cache" / "db" / "flattened")
    same_db(port_db, jax_load_default_db(None, str(tmp_path / "cache")), PROBES)
    assert load_default_db(str(tmp_path / "none"), str(tmp_path / "empty")) is None
    assert jax_load_default_db(str(tmp_path / "none"), str(tmp_path / "empty")) is None
    # a corrupt trivy.db is skipped with a warning, as in the JAX package
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "trivy.db").write_bytes(b"not a bolt file" * 100)
    assert load_default_db(str(tmp_path / "bad"), str(tmp_path / "empty")) is None
    assert not os.path.exists(tmp_path / "bad" / "flattened")
