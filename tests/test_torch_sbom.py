"""The port's ``sbom`` command against the JAX package's: SBOM decode, and
``python -m trivy_tpu_torch sbom --device cpu --format json`` against
``python -m trivy_tpu.cli sbom --format json`` (``Results`` and
``Metadata``) on CycloneDX, in-toto-wrapped CycloneDX, SPDX JSON and SPDX
tag-value documents, with and without OS packages; ``cli.scan_sbom`` run
twice on one loaded DB."""

import json
import random

import pytest

from tests.dbtest import build_db
from tests.test_sbom import CDX
from tests.test_torch_detector import ECOS, synthetic_db, version
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu.sbom.decode import decode as jax_decode
from trivy_tpu_torch import cli
from trivy_tpu_torch.db import VulnDB
from trivy_tpu_torch.sbom.decode import decode

# bucket prefix -> purl type, and how a DB name splits into namespace/name
PURL_TYPES = {"npm": "npm", "go": "golang", "cargo": "cargo", "composer": "composer",
              "pip": "pypi", "maven": "maven", "rubygems": "gem"}
FORMATS = ("cyclonedx", "intoto", "spdx-json", "spdx-tv")


def purl(prefix: str, name: str, ver: str) -> str:
    ns, _, base = name.rpartition(":" if prefix == "maven" else "/")
    path = f"{ns}/{base}" if ns else base
    return f"pkg:{PURL_TYPES[prefix]}/{path}@{ver}"


def components(n: int, with_os: bool, seed: int = 5) -> list[dict]:
    """``n`` library components over the synthetic DB's ecosystems (names
    in and out of the DB, prereleases, duplicates) and, with ``with_os``,
    debian 12 packages with an operating-system component."""
    rng = random.Random(seed)
    schemes = {"pip": "pep440", "maven": "maven", "rubygems": "gem"}
    out = []
    for i in range(n):
        prefix, names = list(ECOS.values())[i % len(ECOS)]
        name = rng.choice(names + ["absent-pkg"])
        ver = version(rng, schemes.get(prefix, "semver"))
        out.append({"type": "library", "name": name, "version": ver,
                    "purl": purl(prefix, name, ver), "bom-ref": f"ref-{i}"})
    out += out[:5]
    if with_os:
        for i in range(40):
            ver = f"1.{rng.randint(0, 5)}.{i}-{rng.randint(0, 3)}"
            out.append({"type": "library", "name": f"lib{i}", "version": ver,
                        "purl": f"pkg:deb/debian/lib{i}@{ver}?arch=amd64&distro=debian-12"})
        out.append({"type": "operating-system", "name": "debian", "version": "12"})
    return out


def document(fmt: str, comps: list[dict]) -> str:
    libs = [c for c in comps if c["type"] == "library"]
    if fmt in ("cyclonedx", "intoto"):
        doc = {"bomFormat": "CycloneDX", "specVersion": "1.5", "components": comps,
               "dependencies": [{"ref": "ref-0", "dependsOn": ["ref-1", "ref-2"]}]}
        if fmt == "intoto":
            doc = {"_type": "https://in-toto.io/Statement/v0.1",
                   "predicateType": "https://cyclonedx.org/bom", "predicate": doc}
        return json.dumps(doc)
    if fmt == "spdx-json":
        return json.dumps({"spdxVersion": "SPDX-2.3", "packages": [
            {"name": c["name"], "versionInfo": c["version"], "licenseConcluded": "MIT",
             "externalRefs": [{"referenceType": "purl", "referenceLocator": c["purl"]}]}
            for c in libs]})
    lines = ["SPDXVersion: SPDX-2.3", "DataLicense: CC0-1.0"]
    for c in libs:
        lines += [f"PackageName: {c['name']}", f"PackageVersion: {c['version']}",
                  f"ExternalRef: PACKAGE-MANAGER purl {c['purl']}"]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def synth_db(tmp_path_factory):
    return synthetic_db(tmp_path_factory.mktemp("synth"))


def run_both(tmp_path, bom: str, db_dir: str, *extra: str) -> tuple[dict, dict]:
    mine, ref = tmp_path / "port.json", tmp_path / "jax.json"
    assert cli.main(["sbom", "--device", "cpu", "--format", "json", "-o", str(mine), "-q",
                     "--db-repository", db_dir, "--cache-dir", str(tmp_path / "c1"),
                     "--stats-out", str(tmp_path / "stats.json"), *extra, bom]) == 0
    assert jax_cli.main(["sbom", "--format", "json", "-o", str(ref), "-q",
                         "--db-repository", db_dir, "--cache-dir", str(tmp_path / "c2"),
                         bom]) == 0
    return json.loads(mine.read_text()), json.loads(ref.read_text())


@pytest.mark.parametrize("with_os", [True, False], ids=["os", "no-os"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_sbom_cli_equals_jax(synth_db, tmp_path, fmt, with_os):
    bom = tmp_path / f"bom.{'spdx' if fmt == 'spdx-tv' else 'json'}"
    bom.write_text(document(fmt, components(700, with_os)))
    mine, ref = run_both(tmp_path, str(bom), synth_db)
    assert mine["Results"] == ref["Results"]
    assert mine["Metadata"] == ref["Metadata"]
    assert (mine["ArtifactName"], mine["ArtifactType"]) == (ref["ArtifactName"],
                                                            ref["ArtifactType"])
    classes = {r["Class"] for r in mine["Results"]}
    assert "lang-pkgs" in classes
    assert ("os-pkgs" in classes) == (with_os and fmt != "spdx-tv")
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["components"] >= 700 and stats["cve.dispatch_count"] == 1
    assert stats["cve.resident_rows"] > 0 and stats["cve.bounds_bytes_uploaded"] > 0
    assert stats["cve.join.seconds"] > 0 and stats["db_load_seconds"] > 0


def test_sbom_cli_fixture_db_equals_jax(tmp_path):
    """The JAX package's own SBOM fixture (an OS component, npm and pypi
    components) on the fixture DB: below BATCH_THRESHOLD, no dispatch."""
    bom = tmp_path / "cdx.json"
    bom.write_text(json.dumps(CDX))
    mine, ref = run_both(tmp_path, str(bom), build_db(tmp_path))
    assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
    assert [r["Class"] for r in mine["Results"]] == ["os-pkgs", "lang-pkgs", "lang-pkgs"]
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["cve.dispatch_count"] == stats["cve.bounds_bytes_uploaded"] == 0


def test_sbom_without_db_equals_jax(tmp_path):
    bom = tmp_path / "cdx.json"
    bom.write_text(json.dumps(CDX))
    mine, ref = run_both(tmp_path, str(bom), str(tmp_path / "no-db"))
    assert mine["Results"] == ref["Results"] == []
    assert mine["Metadata"] == ref["Metadata"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_equals_jax(fmt):
    data = document(fmt, components(60, True)).encode()
    got, want = decode(data), jax_decode(data)

    def shape(blob):
        return (blob.os and blob.os.to_dict(),
                [[p.to_dict() for p in pi.packages] for pi in blob.package_infos],
                [(a.type, a.file_path, [p.to_dict() for p in a.packages])
                 for a in blob.applications])

    assert shape(got) == shape(want)


def test_scan_sbom_twice_on_one_db(synth_db, tmp_path):
    bom = tmp_path / "bom.json"
    bom.write_text(document("cyclonedx", components(700, True)))
    db = VulnDB.load(synth_db)
    first, s1 = cli.scan_sbom(str(bom), db=db, device="cpu")
    second, s2 = cli.scan_sbom(str(bom), db=db, device="cpu")
    assert first.to_dict()["Results"] == second.to_dict()["Results"]
    assert s1["cve.bounds_bytes_uploaded"] > 0 and s2["cve.bounds_bytes_uploaded"] == 0
    assert s1["cve.dispatch_count"] == s2["cve.dispatch_count"] == 1
    assert db._lib_resident.dispatch_count == 2
    assert "db_load_seconds" not in s1


def test_sbom_table_format(synth_db, tmp_path, capsys):
    bom = tmp_path / "bom.json"
    bom.write_text(document("cyclonedx", components(50, True)))
    assert cli.main(["sbom", "--device", "cpu", "-q", "--db-repository", synth_db,
                     str(bom)]) == 0
    out = capsys.readouterr().out
    assert f"{bom} (debian 12) (debian)" in out and "│ Vulnerability" in out
    assert "vulnerabilities (" in out
