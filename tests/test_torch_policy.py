"""Rego ignore policies and VEX documents in the port's report filter
against the JAX package's, both CLIs run in-process from one fresh working
directory over ``test_torch_filter``'s tree and SBOM: ``tests/test_rego.py``'s
policies (its real-world ``--ignore-policy``, rules over vulnerabilities
and secrets, a policy without an ``ignore`` rule, a construct outside the
rego subset), and ``tests/test_vex.py``'s documents in the three formats
(OpenVEX, CycloneDX VEX, CSAF) and its VEX repository layout under
``--cache-dir``, pointed at the tree's vulnerable packages. Reports must be
equal, with and without ``--show-suppressed``; the JSON lists the
suppressed findings either way."""

import copy
import json
import os
from pathlib import Path

import pytest

from tests.dbtest import build_db
from tests.test_rego import REAL_WORLD_POLICY
from tests.test_torch_filter import BOM, make_tree
from tests.test_torch_match import few_torch_threads  # noqa: F401
from tests import test_vex
from trivy_tpu import cli as jax_cli
from trivy_tpu_torch import cli

POLICIES = {
    "real-world": REAL_WORLD_POLICY,
    "one-cve": 'package trivy\n\ndefault ignore = false\n\n'
               'ignore {\n    input.VulnerabilityID == "CVE-2023-0001"\n}\n',
    "secret-rule": 'package trivy\n\ndefault ignore = false\n\n'
                   'ignore {\n    input.RuleID == "aws-access-key-id"\n}\n',
    "pkg-and-severity": 'package trivy\n\nimport rego.v1\n\n'
                        'ignore if {\n    input.PkgName in {"lodash", "musl"}\n'
                        '    input.Severity == "HIGH"\n}\n',
}

# the vulnerable npm package of the tree and of the SBOM
LODASH = "pkg:npm/lodash@4.17.15"
LODASH_CVE = "CVE-2021-23337"


def openvex() -> dict:
    doc = copy.deepcopy(test_vex.OPENVEX)
    doc["statements"][0]["vulnerability"]["name"] = LODASH_CVE
    doc["statements"][0]["products"] = [{"@id": LODASH}]
    return doc


def cyclonedx_vex() -> dict:
    """``test_vex.TestCycloneDXVEX``'s bom-ref document."""
    return {
        "bomFormat": "CycloneDX", "specVersion": "1.5",
        "components": [{"bom-ref": "ref-lodash", "name": "lodash", "purl": LODASH}],
        "vulnerabilities": [{"id": LODASH_CVE,
                             "analysis": {"state": "not_affected", "detail": "sandboxed"},
                             "affects": [{"ref": "ref-lodash"}]}],
    }


def csaf_vex() -> dict:
    """``test_vex.TestCSAF``'s document."""
    return {
        "document": {"category": "csaf_vex"},
        "product_tree": {"branches": [{"product": {
            "product_id": "LODASH",
            "product_identification_helper": {"purl": LODASH}}}]},
        "vulnerabilities": [{"cve": LODASH_CVE,
                             "product_status": {"known_not_affected": ["LODASH"]}}],
    }


def openvex_global() -> dict:
    """``test_vex.TestUnresolvedProducts``'s statement without products: it
    holds for every package, so it also reaches findings without a purl (a
    filesystem scan's lockfile packages carry none)."""
    doc = openvex()
    del doc["statements"][0]["products"]
    return doc


VEX_DOCS = {"openvex": openvex, "cyclonedx": cyclonedx_vex, "csaf": csaf_vex,
            "openvex-global": openvex_global}
# (document, command): the purl-matched documents on the SBOM, whose
# packages carry purls; the global statement on the tree
VEX_CASES = [("openvex", "sbom"), ("cyclonedx", "sbom"), ("csaf", "sbom"),
             ("openvex-global", "sbom"), ("openvex-global", "fs")]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("policy")
    (base / "tree").mkdir()
    make_tree(base / "tree")
    (base / "bom.json").write_text(json.dumps(BOM))
    return {"tree": base / "tree", "bom": base / "bom.json", "db": build_db(base)}


@pytest.fixture
def wd(tmp_path, monkeypatch):
    d = tmp_path / "wd"
    d.mkdir()
    monkeypatch.chdir(d)
    return d


COMMANDS = {
    "fs": lambda e: ["fs", "--scanners", "vuln", "--db-repository", e["db"]],
    "fs-secret": lambda e: ["fs", "--scanners", "vuln,secret", "--db-repository", e["db"]],
    "sbom": lambda e: ["sbom", "--db-repository", e["db"]],
}


def run_both(e, wd: Path, command: str, *extra) -> tuple[dict | None, dict | None, int, int]:
    """Both CLIs from ``wd``, each with its own cache dir (``c1`` the port's,
    ``c2`` the JAX package's): the reports (None when none was written) and
    the exit codes."""
    target = str(e["bom"] if command == "sbom" else e["tree"])
    head = COMMANDS[command](e)
    out1, out2 = wd / "port.json", wd / "jax.json"
    rc1 = cli.main([*head, "--device", "cpu", "--format", "json", "-o", str(out1), "-q",
                    "--cache-dir", str(wd / "c1"), *extra, target])
    rc2 = jax_cli.main([*head, "--backend", "cpu", "--format", "json", "-o", str(out2), "-q",
                        "--cache-dir", str(wd / "c2"), *extra, target])
    read = lambda p: json.loads(p.read_text()) if p.exists() else None  # noqa: E731
    return read(out1), read(out2), rc1, rc2


def found(report: dict) -> set:
    return {f.get("VulnerabilityID") or f.get("RuleID") for r in report["Results"]
            for f in r.get("Vulnerabilities", []) + r.get("Secrets", [])}


def suppressed(report: dict) -> list:
    return [m for r in report["Results"] for m in r.get("ExperimentalModifiedFindings", [])]


@pytest.fixture(scope="module")
def unfiltered(env, tmp_path_factory):
    """The port's unfiltered report of each command."""
    out = {}
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("unfiltered"))  # no ignore or config file here
    try:
        for command, head in COMMANDS.items():
            target = str(env["bom"] if command == "sbom" else env["tree"])
            assert cli.main([*head(env), "--device", "cpu", "--format", "json", "-o",
                             "port.json", "-q", target]) == 0
            out[command] = json.loads(Path("port.json").read_text())
    finally:
        os.chdir(cwd)
    return out


@pytest.mark.parametrize("show", [[], ["--show-suppressed"]], ids=["plain", "show-suppressed"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_rego_policy_equals_jax(env, wd, unfiltered, policy, show):
    (wd / "ignore.rego").write_text(POLICIES[policy])
    command = "fs-secret" if policy == "secret-rule" else "fs"
    mine, ref, rc1, rc2 = run_both(env, wd, command, "--ignore-policy", "ignore.rego", *show)
    assert rc1 == rc2 == 0
    assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
    assert found(unfiltered[command]) - found(mine)  # every policy drops something here
    assert {m["Status"] for m in suppressed(mine)} <= {"ignored"}


@pytest.mark.parametrize("text,needle", [
    ("package trivy\nallow { true }\n", "no 'ignore' rule"),
    ("package trivy\nignore { x := input.a with input as {} }\n", "with"),
], ids=["no-ignore-rule", "unsupported-construct"])
def test_bad_rego_policy_exits_2(env, wd, capsys, text, needle):
    (wd / "bad.rego").write_text(text)
    mine, ref, rc1, rc2 = run_both(env, wd, "fs", "--ignore-policy", "bad.rego")
    assert rc1 == rc2 == 2 and mine is ref is None
    assert needle in capsys.readouterr().err


@pytest.mark.parametrize("fmt,command", VEX_CASES, ids=[f"{d}-{c}" for d, c in VEX_CASES])
def test_vex_document_equals_jax(env, wd, fmt, command):
    (wd / f"doc.{fmt}.json").write_text(json.dumps(VEX_DOCS[fmt]()))
    for show in ([], ["--show-suppressed"]):
        mine, ref, rc1, rc2 = run_both(env, wd, command, "--vex", f"doc.{fmt}.json", *show)
        assert rc1 == rc2 == 0
        assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
        assert LODASH_CVE not in found(mine) and "CVE-2020-7598" in found(mine)
        assert [m["Status"] for m in suppressed(mine)] == ["not_affected"]


@pytest.mark.parametrize("command", ["sbom"])
def test_vex_repository_equals_jax(env, wd, command):
    """``--vex repo`` resolves the VEX repositories under each CLI's
    ``--cache-dir`` (``test_vex.TestVexRepositories``'s layout; its index
    is keyed by purl, so the SBOM's packages meet it)."""
    for cache in (wd / "c1", wd / "c2"):
        repos = test_vex.TestVexRepositories
        repos._make_repo(None, cache, "myrepo", "pkg:npm/lodash", LODASH_CVE, LODASH)
        repos._write_config(None, cache, ["myrepo"])
    mine, ref, rc1, rc2 = run_both(env, wd, command, "--vex", "repo", "--show-suppressed")
    assert rc1 == rc2 == 0
    assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
    assert LODASH_CVE not in found(mine)
    assert [m["Status"] for m in suppressed(mine)] == ["not_affected"]


def test_unreadable_vex_document_is_skipped_as_in_jax(env, wd):
    mine, ref, rc1, rc2 = run_both(env, wd, "sbom", "--vex", "missing.json", "--vex", "repo")
    assert rc1 == rc2 == 0
    assert mine["Results"] == ref["Results"] and LODASH_CVE in found(mine)
