"""The port's report writers, ``--dependency-tree`` and ``convert`` against
the JAX package's, on a tree with an alpine root, an npm v3 lockfile whose
root names its direct dependencies (so packages carry edges), a pip
requirement, a secret and a license file, with non-ASCII text in a package
name, a package license, a secret's lines and a license file, scanned
against ``tests/dbtest.py``'s DB with one finding suppressed by VEX.

- Writer level: the JAX CLI's JSON of that tree read by both packages'
  ``Report.from_dict``; for each of the nine formats both writers must give
  equal bytes (``cosign-vuln`` with the clock pinned in both modules).
- CLI level: ``fs`` (secret only, and vuln+secret+license), ``sbom`` and
  ``image`` with ``--format X --device cpu`` against ``trivy_tpu.cli
  --backend cpu --format X``, and ``rootfs``, ``repo`` and ``vm`` with an
  SBOM format and the dependency tree. Bytes must be equal once the fields
  derived from the scan's clock are masked, and only those (each must
  appear once).
- ``convert`` in both CLIs on the same JSON: whole bytes equal.
"""

import io
import json
import re
import shutil
import subprocess
from datetime import datetime, timezone
from pathlib import Path

import pytest

from tests.dbtest import build_db
from tests.imagetest import docker_save_tar, tar_bytes
from tests.secret_samples import SAMPLES
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu import report as jax_report
from trivy_tpu.report import predicate as jax_predicate
from trivy_tpu.report.template import TemplateError as JaxTemplateError
from trivy_tpu.types import MisconfResult
from trivy_tpu.types import Report as JaxReport
from trivy_tpu_torch import cli, report
from trivy_tpu_torch.report import predicate
from trivy_tpu_torch.report.template import TemplateError
from trivy_tpu_torch.sbom.decode import decode
from trivy_tpu_torch.types import Report

FORMATS = jax_cli.FORMATS
SUPPRESSED = "CVE-2023-0003"  # busybox, unfixed: VEX says not affected
FILES = {
    "etc/alpine-release": "3.18.4\n",
    "lib/apk/db/installed": "P:musl\nV:1.2.3-r0\nL:MIT\n\nP:busybox\nV:1.36.0-r0\n"
                            "L:GPL-2.0-only\n",
    "web/package-lock.json": json.dumps({"name": "web", "lockfileVersion": 3, "packages": {
        "": {"name": "web", "dependencies": {"lodash": "*", "ünïcode-fmt": "*"}},
        "node_modules/lodash": {"version": "4.17.15", "dependencies": {"minimist": "*"}},
        "node_modules/minimist": {"version": "1.2.0"},
        "node_modules/ünïcode-fmt": {"version": "2.0.0"}}}, ensure_ascii=False),
    "web/node_modules/ünïcode-fmt/package.json": json.dumps(
        {"name": "ünïcode-fmt", "version": "2.0.0", "license": "Licença-Livre"},
        ensure_ascii=False),
    "py/requirements.txt": "django==4.0.1\n",
    "src/config.py": f"# café configuration\nkey = '{SAMPLES['github-pat']}'  # naïve\n",
    "LICENSE": "MIT License\n\nCopyright © 2024 Jürgen\n\nPermission is hereby granted, free "
               "of charge, to any person obtaining a copy of this software.\n",
}
VEX = {"@context": "https://openvex.dev/ns/v0.2.0", "@id": "https://example.com/vex-1",
       "statements": [{"vulnerability": {"name": SUPPRESSED}, "status": "not_affected",
                       "justification": "vulnerable_code_not_present"}]}
BOM = {"bomFormat": "CycloneDX", "specVersion": "1.5", "components": [
    {"type": "operating-system", "name": "alpine", "version": "3.18"},
    {"type": "library", "name": "musl", "version": "1.2.3-r0", "licenses": [
        {"license": {"name": "MIT"}}], "purl": "pkg:apk/alpine/musl@1.2.3-r0?distro=alpine-3.18"},
    {"type": "library", "name": "lodash", "version": "4.17.15", "purl": "pkg:npm/lodash@4.17.15"},
    {"type": "library", "name": "ünïcode-fmt", "version": "2.0.0",
     "purl": "pkg:npm/%C3%BCn%C3%AFcode-fmt@2.0.0"},
    {"type": "library", "name": "django", "version": "4.0.1", "purl": "pkg:pypi/django@4.0.1"},
]}
TEMPLATE = (
    "{{ .ArtifactName }} ({{ .ArtifactType }})\n"
    "{{ range .Results }}{{ .Target }} {{ .Class | toUpper }}: {{ len .Vulnerabilities }} "
    "vulnerabilities, {{ len .Secrets }} secrets\n"
    "{{ range .Vulnerabilities }}  {{ .VulnerabilityID }} {{ .PkgName | escapeXML }} "
    "{{ .Severity | toLower }}\n{{ end }}"
    "{{ if .Licenses }}  licenses: {{ .Licenses | json }}\n{{ else }}  no licenses\n{{ end }}"
    "{{ end }}"
)
# the fields each format derives from the scan's clock (Report.created_at,
# or the clock itself for cosign-vuln): two scans differ in these alone
TIME_FIELDS = {
    "json": (r'"CreatedAt": "[^"]*"',),
    "cyclonedx": (r'"serialNumber": "[^"]*"', r'"timestamp": "[^"]*"'),
    "spdx-json": (r'"documentNamespace": "[^"]*"', r'"created": "[^"]*"'),
    "spdx": (r"(?m)^DocumentNamespace: .*$", r"(?m)^Created: .*$"),
    "github": (r'"scanned": "[^"]*"',),
    "cosign-vuln": (r'"CreatedAt": "[^"]*"', r'"scanStartedOn": "[^"]*"',
                    r'"scanFinishedOn": "[^"]*"'),
}
SECRET_CONFIG = "enable-builtin-rules:\n  - github-pat\n  - aws-access-key-id\n"
CLOCK = datetime(2026, 1, 2, 3, 4, 5, 678901, tzinfo=timezone.utc)


def mask(fmt: str, text: str) -> str:
    """``text`` with each time-derived field of ``fmt`` replaced; each must
    appear exactly once."""
    for pat in TIME_FIELDS.get(fmt, ()):
        text, n = re.subn(pat, "<time>", text)
        assert n == 1, (fmt, pat, n)
    return text


class FixedClock(datetime):
    @classmethod
    def now(cls, tz=None):
        return CLOCK


@pytest.fixture
def pinned_clock(monkeypatch):
    """``cosign-vuln``'s clock pinned in both packages' writer."""
    monkeypatch.setattr(jax_predicate, "datetime", FixedClock)
    monkeypatch.setattr(predicate, "datetime", FixedClock)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("formats")
    tree = base / "tree"
    for rel, text in FILES.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_text(text, encoding="utf-8")
    (base / "vex.json").write_text(json.dumps(VEX))
    (base / "bom.json").write_text(json.dumps(BOM, ensure_ascii=False), encoding="utf-8")
    (base / "t.tmpl").write_text(TEMPLATE, encoding="utf-8")
    files = {rel: text.encode() for rel, text in FILES.items()}
    os_layer = {k: files.pop(k) for k in ("etc/alpine-release", "lib/apk/db/installed")}
    image = docker_save_tar(base / "img.tar", [tar_bytes(os_layer), tar_bytes(files)])
    out = {"base": base, "tree": tree, "db": build_db(base), "vex": base / "vex.json",
           "bom": base / "bom.json", "template": base / "t.tmpl", "image": image}
    mkfs = shutil.which("mkfs.ext4")
    if mkfs is not None:  # a raw ext4 disk of the tree, for ``vm``
        out["disk"] = base / "disk.img"
        with open(out["disk"], "wb") as f:
            f.truncate(16 << 20)
        subprocess.run([mkfs, "-q", "-d", str(tree), str(out["disk"])], check=True)
    # the seeded report: the JAX CLI's JSON of the whole inventory, with the
    # VEX-suppressed finding kept
    out["report"] = base / "jax-report.json"
    rc = jax_cli.main(["fs", *COMMANDS["fs-all"](out), "--list-all-pkgs", "--backend", "cpu",
                       "-q", "--format", "json", "-o", str(out["report"]),
                       "--cache-dir", str(base / "c"), str(tree)])
    assert rc == 0
    return out


@pytest.fixture
def wd(tmp_path, monkeypatch):
    """A fresh working directory whose ``trivy-secret.yaml`` (the default
    ``--secret-config`` of both CLIs) keeps two built-in rules: the port's
    plain matcher on the CPU then scans a batch in a fraction of the time."""
    d = tmp_path / "wd"
    d.mkdir()
    (d / "trivy-secret.yaml").write_text(SECRET_CONFIG)
    monkeypatch.chdir(d)
    return d


COMMANDS = {
    "fs-secret": lambda e: ["--scanners", "secret"],
    "fs-all": lambda e: ["--scanners", "vuln,secret,license", "--db-repository", e["db"],
                         "--vex", str(e["vex"]), "--show-suppressed"],
    "sbom": lambda e: ["--db-repository", e["db"]],
    "image": lambda e: ["--scanners", "vuln,secret,license", "--db-repository", e["db"]],
    "rootfs": lambda e: ["--scanners", "vuln,secret,license", "--db-repository", e["db"]],
    "repo": lambda e: ["--scanners", "vuln,secret,license", "--db-repository", e["db"]],
    "vm": lambda e: ["--scanners", "vuln,secret,license", "--db-repository", e["db"]],
}
TARGET = {"fs-secret": "tree", "fs-all": "tree", "sbom": "bom", "image": "image",
          "rootfs": "tree", "repo": "tree", "vm": "disk"}


def format_args(e, fmt: str) -> list[str]:
    if fmt == "template":
        return ["--format", fmt, "-t", f"@{e['template']}"]
    if fmt == "table-tree":
        return ["--format", "table", "--dependency-tree"]
    return ["--format", fmt]


def run_both(e, wd: Path, command: str, fmt: str, *extra: str) -> tuple[str, str, int, int]:
    """Both CLIs' ``command`` with format ``fmt``: the port's output, the JAX
    package's and both exit codes."""
    head = [command.split("-")[0], *COMMANDS[command](e), *format_args(e, fmt), "-q", *extra]
    target = str(e[TARGET[command]])
    out1, out2 = wd / "port.out", wd / "jax.out"
    rc1 = cli.main([*head, "--device", "cpu", "-o", str(out1), "--cache-dir", str(wd / "c1"),
                    target])
    rc2 = jax_cli.main([*head, "--backend", "cpu", "-o", str(out2), "--cache-dir",
                        str(wd / "c2"), target])
    return (out1.read_text(encoding="utf-8"), out2.read_text(encoding="utf-8"), rc1, rc2)


def render(write, rep, fmt: str, **kw) -> str:
    buf = io.StringIO()
    write(rep, fmt, buf, **kw)
    return buf.getvalue()


def test_formats_are_the_jax_cli_formats():
    assert report.FORMATS == jax_cli.FORMATS
    flag = {f.name: f for f in cli.report_flags().flags}["format"]
    assert flag.choices == jax_cli.FORMATS


WRITER_CASES = [(f, {}) for f in FORMATS if f != "template"] + [
    ("template", {"template": TEMPLATE}), ("table", {"dependency_tree": True}),
    ("table", {"show_suppressed": True, "dependency_tree": True})]


@pytest.mark.parametrize("fmt,kw", WRITER_CASES,
                         ids=[f + "".join(f"-{k}" for k in kw) for f, kw in WRITER_CASES])
def test_writer_equals_jax(env, pinned_clock, fmt, kw):
    """Both writers on the JAX CLI's report read back by each package."""
    doc = json.loads(env["report"].read_text(encoding="utf-8"))
    mine = render(report.write, Report.from_dict(doc), fmt, **kw)
    ref = render(jax_report.write, JaxReport.from_dict(doc), fmt, **kw)
    assert mine == ref
    assert len(mine) > 200


def test_seeded_report_covers_the_writers(env):
    """The seeded report holds what the writers render: vulnerabilities,
    packages with edges, a suppressed finding, secrets, licenses, non-ASCII."""
    doc = json.loads(env["report"].read_text(encoding="utf-8"))
    results = doc["Results"]
    assert {r["Class"] for r in results} == {"os-pkgs", "lang-pkgs", "secret", "license",
                                             "license-file"}
    assert any(p["DependsOn"] for r in results for p in r.get("Packages", []))
    suppressed = [m["Finding"]["VulnerabilityID"] for r in results
                  for m in r.get("ExperimentalModifiedFindings", [])]
    assert suppressed == [SUPPRESSED]
    text = env["report"].read_text(encoding="utf-8")
    # the secret engine reads bytes as latin-1, so the line's UTF-8 "é" is two characters
    assert "ünïcode-fmt" in text and "Licença-Livre" in text and "cafÃ©" in text
    assert Report.from_dict(doc).to_dict() == doc


CLI_FORMATS = [*FORMATS, "table-tree"]
CLI_CASES = [(c, f) for c in ("fs-secret", "fs-all", "sbom", "image") for f in CLI_FORMATS]
OTHER_CASES = [(c, f) for c in ("rootfs", "repo", "vm") for f in ("cyclonedx", "table-tree")]


@pytest.mark.parametrize("command,fmt", CLI_CASES, ids=[f"{c}-{f}" for c, f in CLI_CASES])
def test_cli_format_equals_jax(env, wd, command, fmt):
    mine, ref, rc1, rc2 = run_both(env, wd, command, fmt)
    assert rc1 == rc2 == 0
    base = fmt.split("-tree")[0]
    assert mask(base, mine) == mask(base, ref)
    if fmt == "json":  # every report the port makes reads back to itself
        doc = json.loads(mine)
        assert Report.from_dict(doc).to_dict() == doc


@pytest.mark.parametrize("command,fmt", OTHER_CASES, ids=[f"{c}-{f}" for c, f in OTHER_CASES])
def test_other_commands_format_equals_jax(env, wd, command, fmt):
    """``rootfs``, ``repo`` (a path) and ``vm`` take the formats too: the
    whole inventory for an SBOM, the dependency tree for the table."""
    if command == "vm" and "disk" not in env:
        pytest.skip("mkfs.ext4 not available")
    mine, ref, rc1, rc2 = run_both(env, wd, command, fmt)
    assert rc1 == rc2 == 0
    base = fmt.split("-tree")[0]
    assert mask(base, mine) == mask(base, ref)
    assert "lodash" in mine and "minimist" in mine


def test_secret_scan_lists_packages_for_sbom_formats(env, wd):
    """``--scanners secret`` runs the OS identity analyzers alone, but an
    SBOM format needs the whole inventory: every package analyzer runs, as
    in the JAX CLI."""
    mine, _ref, _rc1, _rc2 = run_both(env, wd, "fs-secret", "cyclonedx")
    names = {c["name"] for c in json.loads(mine)["components"]}
    assert {"musl", "busybox", "lodash", "minimist", "ünïcode-fmt", "django"} <= names
    plain, _ref, _rc1, _rc2 = run_both(env, wd, "fs-secret", "json")
    assert not any(r.get("Packages") for r in json.loads(plain)["Results"])


def test_dependency_tree_names_the_planted_packages(env, wd):
    mine, ref, _rc1, _rc2 = run_both(env, wd, "fs-all", "table-tree")
    assert mine == ref
    tree = mine[mine.index("Dependency Origin Tree (Reversed)"):]
    assert "web/package-lock.json" in tree
    assert "minimist@1.2.0, (MEDIUM: 1)" in tree and "lodash@4.17.15 (direct)" in tree
    plain, _ref, _rc1, _rc2 = run_both(env, wd, "fs-all", "table")
    assert "Dependency Origin Tree" not in plain


CONVERT_CASES = [*CLI_FORMATS, "table-suppressed"]


@pytest.mark.parametrize("fmt", CONVERT_CASES)
def test_convert_equals_jax(env, wd, pinned_clock, fmt):
    """``convert`` of the seeded JSON in both CLIs: whole bytes equal."""
    args = (format_args(env, "table") + ["--show-suppressed"] if fmt == "table-suppressed"
            else format_args(env, fmt))
    out1, out2 = wd / "port.out", wd / "jax.out"
    rc1 = cli.main(["convert", *args, "-q", "-o", str(out1), str(env["report"])])
    rc2 = jax_cli.main(["convert", *args, "-q", "-o", str(out2), str(env["report"])])
    assert rc1 == rc2 == 0
    assert out1.read_bytes() == out2.read_bytes()


def test_convert_of_the_ports_json_equals_a_direct_scan(env, wd):
    """``convert`` of the port's own JSON, with the scan's report flags,
    gives the direct scan's bytes."""
    mine, _ref, _rc1, _rc2 = run_both(env, wd, "fs-all", "json", "--list-all-pkgs")
    (wd / "scan.json").write_text(mine, encoding="utf-8")
    for fmt in ("sarif", "cyclonedx", "table-tree"):
        direct, _ref, _rc1, _rc2 = run_both(env, wd, "fs-all", fmt, "--list-all-pkgs")
        out = wd / "converted.out"
        assert cli.main(["convert", *format_args(env, fmt), "--show-suppressed", "-q", "-o",
                         str(out), str(wd / "scan.json")]) == 0
        base = fmt.split("-tree")[0]
        assert mask(base, out.read_text(encoding="utf-8")) == mask(base, direct)


def test_convert_keeps_the_degraded_flag(env, wd):
    """A JAX report marked ``Degraded`` converts to the JAX ``convert``'s
    bytes: the port carries the flag it never sets itself."""
    doc = json.loads(env["report"].read_text(encoding="utf-8"))
    src = wd / "degraded.json"
    src.write_text(json.dumps({**doc, "Degraded": True}), encoding="utf-8")
    for main, out in ((cli.main, wd / "port.out"), (jax_cli.main, wd / "jax.out")):
        assert main(["convert", "--format", "json", "-q", "-o", str(out), str(src)]) == 0
    assert (wd / "port.out").read_bytes() == (wd / "jax.out").read_bytes()
    assert json.loads((wd / "port.out").read_text())["Degraded"] is True


def test_convert_refuses_misconfigurations(env, wd):
    """A report with misconfiguration results, once refused with exit 2,
    now converts to the JAX ``convert``'s bytes in each format that renders
    them."""
    doc = json.loads(env["report"].read_text(encoding="utf-8"))
    doc["Results"].append({"Target": "Dockerfile", "Class": "config", "Type": "dockerfile",
                           "Misconfigurations": [MisconfResult(
                               id="DS002", title="root user", severity="HIGH",
                               message="Last USER command in Dockerfile should not be 'root'",
                               start_line=2, end_line=2, status="FAIL").to_dict()]})
    src = wd / "misconf.json"
    src.write_text(json.dumps(doc), encoding="utf-8")
    for fmt in ("sarif", "table", "json"):
        for main, out in ((cli.main, wd / "port.out"), (jax_cli.main, wd / "jax.out")):
            assert main(["convert", "--format", fmt, "-q", "-o", str(out), str(src)]) == 0
        assert (wd / "port.out").read_bytes() == (wd / "jax.out").read_bytes(), fmt
        assert "DS002" in (wd / "port.out").read_text()


def test_convert_takes_no_device(env):
    with pytest.raises(SystemExit):
        cli.main(["convert", "--device", "cpu", str(env["report"])])


def test_template_errors_equal_jax(env, wd):
    """An unknown template function and a missing template raise the JAX
    writer's error, with its message, from both CLIs."""
    for args, msg in ((["-t", "{{ .ArtifactName | nope }}"],
                       "unsupported template function: nope"),
                      ([], "--format template requires --template")):
        with pytest.raises(TemplateError) as mine:
            cli.main(["convert", "--format", "template", *args, "-o", str(wd / "p.out"),
                      str(env["report"])])
        with pytest.raises(JaxTemplateError) as ref:
            jax_cli.main(["convert", "--format", "template", *args, "-o", str(wd / "j.out"),
                          str(env["report"])])
        assert str(mine.value) == str(ref.value) == msg


def test_cyclonedx_round_trip_through_the_ports_decoder(env, wd):
    """The port's CycloneDX of the tree, decoded by ``sbom/decode.py``,
    gives the packages back, and ``sbom`` of it reports the fs scan's
    vulnerabilities."""
    (wd / "bom.json").write_text(run_both(env, wd, "fs-secret", "cyclonedx")[0],
                                 encoding="utf-8")
    blob = decode((wd / "bom.json").read_bytes())
    assert (blob.os.family, blob.os.name) == ("alpine", "3.18")
    got = {(p.name, p.version) for a in blob.applications for p in a.packages}
    got |= {(p.name, p.version) for pi in blob.package_infos for p in pi.packages}
    assert {("musl", "1.2.3-r0"), ("lodash", "4.17.15"), ("minimist", "1.2.0"),
            ("ünïcode-fmt", "2.0.0"), ("django", "4.0.1")} <= got
    assert cli.main(["fs", "--scanners", "vuln", "--db-repository", env["db"], "--device",
                     "cpu", "-q", "--format", "json", "-o", str(wd / "fs.json"),
                     str(env["tree"])]) == 0
    assert cli.main(["sbom", "--db-repository", env["db"], "--device", "cpu", "-q",
                     "--format", "json", "-o", str(wd / "sbom.json"), str(wd / "bom.json")]) == 0

    def vulns(path):
        return {(v["VulnerabilityID"], v["PkgName"], v["InstalledVersion"])
                for r in json.loads(path.read_text())["Results"]
                for v in r.get("Vulnerabilities", [])}

    assert vulns(wd / "sbom.json") == vulns(wd / "fs.json")
    assert len(vulns(wd / "fs.json")) >= 5

