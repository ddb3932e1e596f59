"""The ``sbom`` command's scan group (``--scanners``, ``--skip-dirs``,
``--skip-files``, ``--parallel``, ``--no-host-fallback``) against the JAX
CLI's ``sbom``: a CycloneDX BOM of 700 components over the synthetic DB's
ecosystems and a debian root, every component carrying a license, scanned
with each scanner list and each of ``--skip-dirs``, ``--parallel 3`` and
``TRIVY_TPU_PARALLEL``, all from one working directory. A list without
``vuln`` scans ``vuln``; any other is kept, so ``license`` reports the
packages' licenses. The JSON ``Results`` and ``Metadata`` must be equal."""

import json

import pytest

from tests.test_torch_detector import synthetic_db
from tests.test_torch_match import few_torch_threads  # noqa: F401
from tests.test_torch_sbom import components, document
from trivy_tpu import cli as jax_cli
from trivy_tpu_torch import cli

LICENSES = ({"license": {"id": "MIT"}}, {"license": {"id": "Apache-2.0"}},
            {"license": {"id": "GPL-3.0-only"}}, {"license": {"name": "Custom EULA"}})


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("sbomgroup")
    comps = components(700, with_os=True)
    for i, c in enumerate(comps):
        if c["type"] == "library":
            c["licenses"] = [LICENSES[i % len(LICENSES)]]
    bom = base / "bom.json"
    bom.write_text(document("cyclonedx", comps))
    return {"bom": str(bom), "db": synthetic_db(base / "db")}


@pytest.fixture
def wd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for name in ("PARALLEL", "SCANNERS", "SKIP_DIRS", "SERVER"):
        monkeypatch.delenv(f"TRIVY_TPU_{name}", raising=False)
    return tmp_path


SCANNERS = ["vuln", "secret", "vuln,license", "vuln,secret,license"]
OPTIONS = {"skip-dirs": ["--skip-dirs", "usr,vendor", "--skip-files", "a.txt"],
           "parallel-3": ["--parallel", "3"], "env-parallel": []}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("scanners", SCANNERS)
def test_sbom_scan_group_equals_jax(env, wd, monkeypatch, scanners, option):
    if option == "env-parallel":
        monkeypatch.setenv("TRIVY_TPU_PARALLEL", "3")
    tail = ["--scanners", scanners, *OPTIONS[option], "--format", "json", "-q",
            "--db-repository", env["db"], env["bom"]]
    assert cli.main(["sbom", "--device", "cpu", "-o", str(wd / "port.json"),
                     "--cache-dir", str(wd / "c1"), "--stats-out", str(wd / "s.json"),
                     *tail]) == 0
    assert jax_cli.main(["sbom", "-o", str(wd / "jax.json"), "--cache-dir", str(wd / "c2"),
                         *tail]) == 0
    mine, ref = (json.loads((wd / f"{t}.json").read_text()) for t in ("port", "jax"))
    assert mine["Results"] == ref["Results"]
    assert mine["Metadata"] == ref["Metadata"]
    classes = {r["Class"] for r in mine["Results"]}
    assert "lang-pkgs" in classes and "os-pkgs" in classes
    assert ("license" in classes) == ("license" in scanners)
    if "license" in scanners:
        names = {d["Name"] for r in mine["Results"] if r["Class"] == "license"
                 for d in r["Licenses"]}
        assert {"MIT", "Apache-2.0", "GPL-3.0-only"} <= names
    # the join ran on the port's device path (700 components)
    assert json.loads((wd / "s.json").read_text())["cve.dispatch_count"] == 1


def test_scan_sbom_applies_the_jax_scanner_rule(env):
    """``scan_sbom``: a list without ``vuln`` scans ``vuln`` only
    (``misconfig`` alone too, as in JAX); with it, the
    list stays; an unknown scanner is refused."""
    from trivy_tpu_torch.db import VulnDB

    db = VulnDB.load(env["db"])
    runs = {s: cli.scan_sbom(env["bom"], db=db, device="cpu", scanners=s)[0].to_dict()
            for s in (("vuln",), ("secret",), ("license",), ("misconfig",),
                      ("vuln", "license"))}
    assert runs[("secret",)]["Results"] == runs[("vuln",)]["Results"]
    assert runs[("license",)]["Results"] == runs[("vuln",)]["Results"]
    assert runs[("misconfig",)]["Results"] == runs[("vuln",)]["Results"]
    assert len(runs[("vuln", "license")]["Results"]) > len(runs[("vuln",)]["Results"])
    with pytest.raises(ValueError, match="unsupported scanners"):
        cli.scan_sbom(env["bom"], db=db, device="cpu", scanners=("rbac",))
