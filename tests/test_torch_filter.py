"""The port's report filter and flag layer against the JAX package's CLI,
both run in-process from one fresh working directory: a plain
``.trivyignore`` there, a YAML ignore file with an expired entry and
``paths``, ``--severity``, ``trivy-tpu.yaml`` (``scan.skip-dirs``,
``severity``), ``TRIVY_TPU_SEVERITY``, a Python ``--ignore-policy`` with
``--show-suppressed``, ``--exit-code``, over ``fs --scanners secret``, ``fs
--scanners vuln`` and ``sbom``. Rego policies and ``--vex`` are held
against the JAX package in ``test_torch_policy.py``."""

import json
from pathlib import Path

import pytest

from tests.dbtest import build_db
from tests.secret_samples import SAMPLES
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu_torch import cli

YAML_IGNORE = """\
vulnerabilities:
  - id: CVE-2021-23337
    paths: ["lod*"]
  - id: CVE-2023-2222
    paths: ["nomatch/*"]
  - id: CVE-2023-0002
    expired_at: 2000-01-01
  - id: CVE-2020-7598
    statement: accepted risk
secrets:
  - id: github-pat
    paths: ["src/*"]
"""

POLICY = """\
def ignore_vulnerability(v):
    return v["Severity"] == "MEDIUM"


def ignore(finding, kind):
    return kind == "secret" and finding["RuleID"] == "aws-access-key-id"
"""

def make_tree(root: Path) -> None:
    files = {
        "src/a.py": f"key = '{SAMPLES['github-pat']}'\n",
        "lib/b.env": f"AWS={SAMPLES['aws-access-key-id']}\n",
        "sub/creds.txt": f"aws = {SAMPLES['aws-access-key-id']}\n",
        "etc/alpine-release": "3.18.4\n",
        "lib/apk/db/installed": "P:musl\nV:1.2.3-r0\nL:MIT\n\nP:busybox\nV:1.36.0-r0\n"
                                "L:GPL-2.0-only\n",
        "web/package-lock.json": json.dumps({"lockfileVersion": 3, "packages": {
            "node_modules/lodash": {"version": "4.17.15"},
            "node_modules/minimist": {"version": "1.2.0"}}}),
        "py/requirements.txt": "django==4.0.1\n",
    }
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)


BOM = {"bomFormat": "CycloneDX", "specVersion": "1.5", "components": [
    {"type": "operating-system", "name": "alpine", "version": "3.18"},
    {"type": "library", "name": "musl", "version": "1.2.3-r0",
     "purl": "pkg:apk/alpine/musl@1.2.3-r0?distro=alpine-3.18"},
    {"type": "library", "name": "busybox", "version": "1.36.0-r0",
     "purl": "pkg:apk/alpine/busybox@1.36.0-r0?distro=alpine-3.18"},
    {"type": "library", "name": "lodash", "version": "4.17.15", "purl": "pkg:npm/lodash@4.17.15"},
    {"type": "library", "name": "minimist", "version": "1.2.0",
     "purl": "pkg:npm/minimist@1.2.0"},
]}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("filter")
    make_tree(base / "tree")
    (base / "bom.json").write_text(json.dumps(BOM))
    return {"tree": base / "tree", "bom": base / "bom.json", "db": build_db(base)}


@pytest.fixture
def wd(tmp_path, monkeypatch):
    d = tmp_path / "wd"
    d.mkdir()
    monkeypatch.chdir(d)
    monkeypatch.delenv("TRIVY_TPU_SEVERITY", raising=False)
    return d


COMMANDS = {
    "fs-secret": lambda e: ["fs", "--scanners", "secret"],
    "fs-vuln": lambda e: ["fs", "--scanners", "vuln", "--db-repository", e["db"]],
    "sbom": lambda e: ["sbom", "--db-repository", e["db"]],
}


def run_both(e, wd: Path, command: str, *extra) -> tuple[dict, dict, int, int]:
    target = str(e["bom"] if command == "sbom" else e["tree"])
    head = COMMANDS[command](e)
    out1, out2 = wd / "port.json", wd / "jax.json"
    rc1 = cli.main([*head, "--device", "cpu", "--format", "json", "-o", str(out1), "-q",
                    "--cache-dir", str(wd / "c1"), *extra, target])
    rc2 = jax_cli.main([*head, "--backend", "cpu", "--format", "json", "-o", str(out2), "-q",
                        "--cache-dir", str(wd / "c2"), *extra, target])
    return json.loads(out1.read_text()), json.loads(out2.read_text()), rc1, rc2


def ids(report, key="VulnerabilityID"):
    return sorted(f.get(key) for r in report["Results"]
                  for f in r.get("Vulnerabilities", []) + r.get("Secrets", [])
                  if f.get(key))


def assert_equal(mine, ref):
    assert mine["Results"] == ref["Results"]
    assert mine["Metadata"] == ref["Metadata"]


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_unfiltered_equals_jax(env, wd, command):
    mine, ref, rc1, rc2 = run_both(env, wd, command)
    assert_equal(mine, ref)
    assert rc1 == rc2 == 0 and mine["Results"]


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_trivyignore_in_working_directory(env, wd, command):
    """A plain ``.trivyignore`` in the working directory applies."""
    (wd / ".trivyignore").write_text("# accepted\nCVE-2021-23337\nCVE-2023-0003  # unfixed\n"
                                     "github-pat\n")
    mine, ref, _rc1, _rc2 = run_both(env, wd, command)
    assert_equal(mine, ref)
    got = ids(mine) + ids(mine, "RuleID")
    assert got and not {"CVE-2021-23337", "CVE-2023-0003", "github-pat"} & set(got)


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_yaml_ignorefile_expiry_and_paths(env, wd, command):
    (wd / "ignore.yaml").write_text(YAML_IGNORE)
    mine, ref, _rc1, _rc2 = run_both(env, wd, command, "--ignorefile", "ignore.yaml",
                                     "--show-suppressed")
    assert_equal(mine, ref)
    got = set(ids(mine) + ids(mine, "RuleID"))
    assert "CVE-2020-7598" not in got
    if command == "fs-vuln":  # an expired entry, and a path that matches nothing
        assert {"CVE-2023-0002", "CVE-2023-2222"} <= got
    if command != "fs-secret":
        assert "CVE-2021-23337" not in got
    if command == "fs-secret":
        assert "github-pat" not in got and "aws-access-key-id" in got
    suppressed = [m for r in mine["Results"] for m in r.get("ExperimentalModifiedFindings", [])]
    assert suppressed and all(m["Status"] == "ignored" for m in suppressed)


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_severity_flag(env, wd, command):
    mine, ref, _rc1, _rc2 = run_both(env, wd, command, "--severity", "HIGH,CRITICAL")
    assert_equal(mine, ref)
    sevs = {f["Severity"] for r in mine["Results"]
            for f in r.get("Vulnerabilities", []) + r.get("Secrets", [])}
    assert sevs and sevs <= {"HIGH", "CRITICAL"}


def test_config_file_skip_dirs(env, wd):
    """``trivy-tpu.yaml`` in the working directory applies: ``sub/`` is not
    scanned."""
    (wd / "trivy-tpu.yaml").write_text('scan:\n  skip-dirs: ["sub"]\n')
    mine, ref, _rc1, _rc2 = run_both(env, wd, "fs-secret")
    assert_equal(mine, ref)
    targets = {r["Target"] for r in mine["Results"]}
    assert "sub/creds.txt" not in targets and "lib/b.env" in targets


@pytest.mark.parametrize("source", ["cli", "env", "config"])
def test_compliance_setting_equals_jax(env, wd, monkeypatch, source):
    """``compliance`` from the command line, the environment or
    ``trivy-tpu.yaml``: both CLIs write the spec's control report of the
    filtered scan instead of the scan's, byte for byte."""
    extra = []
    if source == "cli":
        extra = ["--compliance", "docker-cis-1.6.0"]
    elif source == "env":
        monkeypatch.setenv("TRIVY_TPU_COMPLIANCE", "docker-cis-1.6.0")
    else:
        (wd / "trivy-tpu.yaml").write_text("compliance: docker-cis-1.6.0\n")
    mine, ref, rc1, rc2 = run_both(env, wd, "fs-vuln", *extra)
    assert rc1 == rc2 == 0
    assert mine == ref
    assert mine["ID"] == "docker-cis-1.6.0" and "SummaryControls" in mine
    assert (wd / "port.json").read_bytes() == (wd / "jax.json").read_bytes()


@pytest.mark.parametrize("source", ["env", "config"])
def test_dependency_tree_setting_equals_jax(env, wd, monkeypatch, source):
    """``dependency-tree`` from the environment or ``trivy-tpu.yaml`` is
    ported: the port lists every package, as the JAX CLI does, and writes
    the JAX CLI's table bytes."""
    if source == "env":
        monkeypatch.setenv("TRIVY_TPU_DEPENDENCY_TREE", "true")
    else:
        (wd / "trivy-tpu.yaml").write_text("dependency-tree: true\n")
    mine, ref, rc1, rc2 = run_both(env, wd, "fs-vuln")
    assert rc1 == rc2 == 0
    assert_equal(mine, ref)
    assert any(r.get("Packages") for r in mine["Results"])
    tables = []
    for main, device in ((cli.main, ["--device", "cpu"]), (jax_cli.main, ["--backend", "cpu"])):
        out = wd / f"table{len(tables)}.txt"
        assert main([*COMMANDS["fs-vuln"](env), *device, "-q", "-o", str(out),
                     "--cache-dir", str(wd / f"c{len(tables) + 3}"), str(env["tree"])]) == 0
        tables.append(out.read_text())
    assert tables[0] == tables[1] and "│ lodash" in tables[0]


# the report group's compliance spec on fs and on sbom: the setting the
# port lacked last, now taken from every source as the JAX CLI takes it
COMPLIANCE = {"fs-secret": "docker-cis-1.6.0", "sbom": "k8s-nsa-1.0"}


@pytest.mark.parametrize("command", ["fs-secret", "sbom"])
def test_compliance_settings_per_command_equal_jax(env, wd, monkeypatch, command):
    """``compliance`` on ``fs`` and ``sbom``, from the config file and then
    from the environment (``TRIVY_TPU_COMPLIANCE``, which wins): the JAX
    CLI's control report."""
    (wd / "trivy-tpu.yaml").write_text(f"compliance: {COMPLIANCE[command]}\n")
    mine, ref, rc1, rc2 = run_both(env, wd, command)
    assert rc1 == rc2 == 0 and mine == ref and mine["ID"] == COMPLIANCE[command]
    monkeypatch.setenv("TRIVY_TPU_COMPLIANCE", "docker-cis-1.6.0")
    mine, ref, rc1, rc2 = run_both(env, wd, command)
    assert rc1 == rc2 == 0 and mine == ref and mine["ID"] == "docker-cis-1.6.0"


@pytest.mark.parametrize("command,config", [
    ("fs-secret", "server:\n  addr: {url}\n"),
    ("sbom", "server:\n  addr: http://127.0.0.1:9\n"),
    ("sbom", "scan:\n  parallel: 3\n"),
], ids=["fs-server-addr", "sbom-server-addr", "sbom-scan-parallel"])
def test_client_server_and_scan_settings_equal_jax(env, wd, command, config):
    """``server.addr`` and ``scan.parallel``, refused before the port had
    them: from the config file each gives the JAX CLI's ``Results``. On
    ``fs`` both clients scan through a port server on the CPU; on ``sbom``
    both packages ignore the address (never contacted) and scan locally."""
    from trivy_tpu_torch.cache import new_cache
    from trivy_tpu_torch.rpc.server import start_server

    httpd, port = start_server(cache=new_cache("memory"), device="cpu")
    try:
        (wd / "trivy-tpu.yaml").write_text(config.format(url=f"http://127.0.0.1:{port}"))
        mine, ref, rc1, rc2 = run_both(env, wd, command)
    finally:
        httpd.shutdown()
    assert rc1 == rc2 == 0
    assert_equal(mine, ref)
    assert mine["Results"]
    scans = httpd.service.metrics.scans.value()
    assert scans == (2 if command == "fs-secret" else 0)


def test_ported_and_unknown_settings_still_resolve(env, wd, monkeypatch):
    """A variable of a ported flag applies, and keys and variables of no
    flag of either package stay ignored, as the JAX package ignores them."""
    (wd / "trivy-tpu.yaml").write_text(
        "severity: [CRITICAL]\nno-such-key: 1\nscan:\n  no-such-key: x\n")
    monkeypatch.setenv("TRIVY_TPU_SEVERITY", "HIGH")
    monkeypatch.setenv("TRIVY_TPU_NO_SUCH_FLAG", "1")
    mine, ref, rc1, rc2 = run_both(env, wd, "fs-vuln")
    assert rc1 == rc2 == 0
    assert_equal(mine, ref)
    sevs = {f["Severity"] for r in mine["Results"] for f in r.get("Vulnerabilities", [])}
    assert sevs == {"HIGH"}


def test_jax_flag_table_matches_the_jax_cli():
    """Every command the port shares with the JAX CLI has the JAX flags:
    each flag's name, config key and environment name, and no other. So no
    JAX setting is dropped from the command line, the environment or the
    config file."""
    from trivy_tpu_torch.flag import ENV_PREFIX

    assert set(cli._TARGET_GROUPS) == {
        "fs", "rootfs", "repo", "watch", "image", "vm", "sbom", "convert", "server", "clean"}
    assert set(cli._TARGET_GROUPS) <= set(jax_cli._TARGET_GROUPS)
    for command, groups in cli._TARGET_GROUPS.items():
        want = sorted((f.name, f.config_name) for g in jax_cli._TARGET_GROUPS[command]
                      for f in g().flags)
        got = sorted((f.name, f.config_name) for g in groups for f in g().flags)
        assert got == want, command
        assert all(f.env_name == ENV_PREFIX + f.name.upper().replace("-", "_")
                   for g in groups for f in g().flags)


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_config_file_severity_and_explicit_config(env, wd, command):
    (wd / "trivy-tpu.yaml").write_text("severity: [CRITICAL]\n")
    (wd / "other.yaml").write_text("severity: [LOW, MEDIUM]\n")
    mine, ref, _rc1, _rc2 = run_both(env, wd, command)
    assert_equal(mine, ref)
    mine2, ref2, _rc1, _rc2 = run_both(env, wd, command, "-c", "other.yaml")
    assert_equal(mine2, ref2)
    assert mine != mine2 or not mine["Results"]


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_severity_from_environment(env, wd, command, monkeypatch):
    (wd / "trivy-tpu.yaml").write_text("severity: [CRITICAL]\n")
    monkeypatch.setenv("TRIVY_TPU_SEVERITY", "HIGH")  # env beats the config file
    mine, ref, _rc1, _rc2 = run_both(env, wd, command)
    assert_equal(mine, ref)
    sevs = {f["Severity"] for r in mine["Results"]
            for f in r.get("Vulnerabilities", []) + r.get("Secrets", [])}
    assert sevs <= {"HIGH"}
    mine2, ref2, _rc1, _rc2 = run_both(env, wd, command, "--severity", "LOW")  # CLI beats env
    assert_equal(mine2, ref2)


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_python_ignore_policy_show_suppressed(env, wd, command):
    (wd / "policy.py").write_text(POLICY)
    for extra in ([], ["--show-suppressed"]):
        mine, ref, _rc1, _rc2 = run_both(env, wd, command, "--ignore-policy", "policy.py",
                                         *extra)
        assert_equal(mine, ref)
        got = set(ids(mine) + ids(mine, "RuleID"))
        assert "aws-access-key-id" not in got and "CVE-2020-7598" not in got


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_exit_code(env, wd, command):
    mine, ref, rc1, rc2 = run_both(env, wd, command, "--exit-code", "3")
    assert_equal(mine, ref)
    assert rc1 == rc2 == 3
    (wd / ".trivyignore").write_text("CVE-2023-0001\nCVE-2023-0002\nCVE-2023-0003\n"
                                     "CVE-2021-23337\nCVE-2020-7598\nCVE-2023-2222\n"
                                     "github-pat\naws-access-key-id\n")
    mine, ref, rc1, rc2 = run_both(env, wd, command, "--exit-code", "3")
    assert_equal(mine, ref)
    assert rc1 == rc2 == 0 and mine["Results"] == []


def test_bad_flag_values_refused(env, wd):
    for args in (["--severity", "SEVERE"], ["--exit-code", "x"], ["-c", "missing.yaml"]):
        with pytest.raises(SystemExit):
            cli.main(["fs", "--device", "cpu", "-q", *args, str(env["tree"])])


@pytest.mark.parametrize("source", ["env", "config"])
def test_image_flags_from_environment_and_config(wd, tmp_path, monkeypatch, source):
    """``image.source``, ``image.docker.host`` and ``incremental.diff-base``
    (or ``TRIVY_TPU_IMAGE_SRC``, ``TRIVY_TPU_DOCKER_HOST``,
    ``TRIVY_TPU_DIFF_BASE``) reach the image scan in both CLIs: a bare
    reference resolves through the fake daemon they name, and the base the
    daemon also holds seeds the shared layers. No socket of the machine is
    probed."""
    from tests.daemontest import FakeDockerDaemon
    from tests.test_torch_diff_base import build_images
    from trivy_tpu.fanal import image_daemon as jax_daemon
    from trivy_tpu_torch.fanal import image_daemon as port_daemon

    monkeypatch.delenv("DOCKER_HOST", raising=False)
    for mod in (jax_daemon, port_daemon):
        for name in ("DOCKER_SOCKETS", "PODMAN_SOCKETS", "CONTAINERD_SOCKETS"):
            monkeypatch.setattr(mod, name, [])
    images = build_images(tmp_path)
    daemon = FakeDockerDaemon(str(tmp_path / "d.sock")).start()
    try:
        for ref in ("base", "derived"):
            daemon.add_image(f"{ref}:1", Path(images[ref]).read_bytes())
        settings = {"IMAGE_SRC": "docker", "DOCKER_HOST": daemon.socket_path,
                    "DIFF_BASE": "base:1"}
        if source == "env":
            for k, v in settings.items():
                monkeypatch.setenv(f"TRIVY_TPU_{k}", v)
        else:
            (wd / "trivy-tpu.yaml").write_text(
                f"image:\n  source: [docker]\n  docker:\n    host: {daemon.socket_path}\n"
                "incremental:\n  diff-base: base:1\n")
        out1, out2 = wd / "port.json", wd / "jax.json"
        assert cli.main(["image", "--device", "cpu", "--format", "json", "-o", str(out1), "-q",
                         "--cache-dir", str(wd / "c1"), "--stats-out", str(wd / "s.json"),
                         "--scanners", "secret", "derived:1"]) == 0
        assert jax_cli.main(["image", "--backend", "cpu", "--format", "json", "-o", str(out2),
                             "-q", "--cache-dir", str(wd / "c2"), "--scanners", "secret",
                             "derived:1"]) == 0
    finally:
        daemon.stop()
    mine, ref = json.loads(out1.read_text()), json.loads(out2.read_text())
    assert_equal(mine, ref)
    assert mine["ArtifactName"] == ref["ArtifactName"] == "derived:1"
    stats = json.loads((wd / "s.json").read_text())
    assert (stats["layers_seeded"], stats["layers_analyzed"]) == (2, 1)
