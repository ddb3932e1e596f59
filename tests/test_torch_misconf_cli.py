"""``--scanners misconfig`` through the port's CLI against the JAX CLI, on
the CPU: ``fs``, ``rootfs``, ``repo``, ``image``, ``vm`` and ``watch``
with ``misconfig,secret,license`` give the JSON ``Results`` and
``Metadata`` of ``python -m trivy_tpu.cli … --backend cpu --format json``;
table and SARIF equal byte for byte; ``convert``, the severity filter, the
ignore file and an ignore policy; ``--config-check`` Python and Rego files
and ``--misconfig-scanners`` from the command line, the environment and the
config file; the incremental unit keys; client mode across packages; and
the inputs once refused, now equal to the JAX CLI's: ``cloudformation`` or
``helm`` named from every source, a CloudFormation template or a chart met
by a default scan, ``--fleet`` with ``misconfig``, and a ``misconfig``
fleet shard.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from tests.imagetest import docker_save_tar, tar_bytes
from tests.secret_samples import SAMPLES
from tests.test_rego import K8S_CHECK
from tests.test_torch_match import few_torch_threads  # noqa: F401
from tests.test_torch_misconf import (  # noqa: F401  (the autouse fixture)
    DOCKERFILES,
    MANIFESTS,
    PY_CHECK,
    _clean_custom_checks,
)
from trivy_tpu import cli as jax_cli
from trivy_tpu.misconf.checks import checks_for as jax_checks_for
from trivy_tpu_torch import cli
from trivy_tpu_torch.cache import new_cache

SECRET_CONFIG = "enable-builtin-rules:\n  - github-pat\n"
SCANNERS = "misconfig,secret,license"
MIT = ("MIT License\n\nCopyright (c) 2024 Example\n\nPermission is hereby granted, free of "
       "charge, to any person obtaining a copy of this software and associated documentation "
       "files (the \"Software\"), to deal in the Software without restriction.\n")
FILES = {
    **{f"svc/{k}": v for k, v in DOCKERFILES.items()},
    **{f"deploy/{k}": v for k, v in MANIFESTS.items()},
    "config/values.yaml": b"replicas: 3\ndebug: true\n",
    "config/settings.json": b'{\n  "debug": true,\n  "port": 8080\n}\n',
    "src/app.py": f"key = '{SAMPLES['github-pat']}'\n".encode(),
    "LICENSE": MIT.encode(),
}
HISTORY = [{"created_by": "/bin/sh -c #(nop) ADD file:abc in / "},
           {"created_by": "/bin/sh -c #(nop)  CMD [\"sh\"]", "empty_layer": True},
           {"created_by": "/bin/sh -c apk add curl"},
           {"created_by": "/bin/sh -c #(nop)  USER root", "empty_layer": True}]


def write_tree(root: Path, files: dict) -> Path:
    for rel, data in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    return root


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("misconf-cli")
    tree = write_tree(base / "tree", FILES)
    layer0 = tar_bytes({"etc/alpine-release": b"3.19.1\n",
                        **{f"app/{k}": v for k, v in FILES.items() if k.startswith("svc/")}})
    layer1 = tar_bytes({k: v for k, v in FILES.items() if not k.startswith("svc/")})
    image = docker_save_tar(base / "img.tar", [layer0, layer1], history=HISTORY)
    out = {"base": base, "tree": tree, "image": image}
    repo = base / "repo"
    shutil.copytree(tree, repo)
    for args in (["init", "-q"], ["add", "-A"], ["-c", "user.email=a@b", "-c", "user.name=a",
                                                  "commit", "-q", "-m", "base"]):
        subprocess.run(["git", *args], cwd=repo, check=True, capture_output=True)
    out["repo"] = repo
    mkfs = shutil.which("mkfs.ext4")
    if mkfs is not None:
        out["disk"] = base / "disk.img"
        with open(out["disk"], "wb") as f:
            f.truncate(16 << 20)
        subprocess.run([mkfs, "-q", "-d", str(tree), str(out["disk"])], check=True)
    checks = base / "checks"
    checks.mkdir()
    (checks / "user.py").write_text(PY_CHECK)
    (checks / "k8s.rego").write_text(K8S_CHECK)
    out["checks"] = checks
    # the JAX registry loaded once in this process: the JAX package reads
    # it half loaded when an image's layers first use it at once
    jax_checks_for("dockerfile")
    return out


@pytest.fixture
def wd(tmp_path, monkeypatch):
    d = tmp_path / "wd"
    d.mkdir()
    (d / "trivy-secret.yaml").write_text(SECRET_CONFIG)
    monkeypatch.chdir(d)
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path))
    return d


TARGET = {"fs": "tree", "rootfs": "tree", "repo": "repo", "image": "image", "vm": "disk"}


def run_both(wd: Path, command: str, target, *args: str, fmt: str = "json"):
    """Both CLIs from ``wd`` on their own cache directories: the port's
    output, the JAX package's (None when not written) and both exit codes."""
    outs = []
    rcs = []
    for tag, main, dev in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, ["--backend", "cpu"])):
        out = wd / f"{tag}.{fmt}"
        out.unlink(missing_ok=True)
        rcs.append(main([command, *dev, "--format", fmt, "-o", str(out), "-q", "--cache-dir",
                         str(wd / f"c-{tag}"), *args, str(target)]))
        outs.append(out.read_text(encoding="utf-8") if out.exists() else None)
    return outs[0], outs[1], rcs[0], rcs[1]


def assert_json_equal(mine: str, ref: str) -> dict:
    a, b = json.loads(mine), json.loads(ref)
    assert a["Results"] == b["Results"]
    assert a["Metadata"] == b["Metadata"]
    assert a["ArtifactType"] == b["ArtifactType"]
    return a


def failed_ids(doc: dict) -> dict[str, set]:
    return {r["Target"]: {m["ID"] for m in r.get("Misconfigurations", [])
                          if m["Status"] == "FAIL"}
            for r in doc["Results"] if r["Class"] == "config"}


@pytest.mark.parametrize("command", sorted(TARGET))
def test_json_equals_jax(env, wd, command):
    if TARGET[command] not in env:
        pytest.skip("mkfs.ext4 is not installed")
    mine, ref, rc1, rc2 = run_both(wd, command, env[TARGET[command]], "--scanners", SCANNERS)
    assert rc1 == rc2 == 0
    doc = assert_json_equal(mine, ref)
    fails = failed_ids(doc)
    prefix = "app/svc/" if command == "image" else "svc/"
    assert {"DS001", "DS002"} <= fails[prefix + "Dockerfile"]
    assert "KSV017" in fails["deploy/c.yaml"]
    assert not fails["deploy/p.yaml"]
    assert any(r["Class"] == "secret" for r in doc["Results"])
    assert any(r.get("Licenses") for r in doc["Results"])
    if command == "image":
        assert {"DS005", "DS025"} <= fails["Dockerfile (image history)"]


@pytest.mark.parametrize("fmt", ["table", "sarif"])
@pytest.mark.parametrize("command", ["fs", "image"])
def test_table_and_sarif_bytes_equal_jax(env, wd, command, fmt):
    mine, ref, rc1, rc2 = run_both(wd, command, env[TARGET[command]], "--scanners", SCANNERS,
                                   fmt=fmt)
    assert rc1 == rc2 == 0 and mine == ref
    assert "DS002" in mine


def test_watch_equals_jax(env, wd):
    mine, ref, rc1, rc2 = run_both(wd, "watch", env["tree"], "--scanners", "misconfig,secret",
                                   "--watch-count", "1")
    assert rc1 == rc2 == 0
    assert failed_ids(assert_json_equal(mine, ref))


@pytest.mark.parametrize("fmt", ["json", "table", "sarif", "template"])
def test_convert_of_a_jax_report_equals_jax(env, wd, fmt):
    src = wd / "report.json"
    assert jax_cli.main(["fs", "--scanners", SCANNERS, "--backend", "cpu", "--format", "json",
                         "-q", "-o", str(src), "--cache-dir", str(wd / "c"),
                         str(env["tree"])]) == 0
    extra = ["-t", "{{ range .Results }}{{ .Target }} {{ len .Misconfigurations }}\n{{ end }}"] \
        if fmt == "template" else []
    outs = []
    for main, tag in ((cli.main, "port"), (jax_cli.main, "jax")):
        out = wd / f"{tag}.out"
        assert main(["convert", "--format", fmt, *extra, "-q", "-o", str(out), str(src)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("case", ["severity", "ignorefile", "yaml-ignorefile", "policy",
                                  "policy-suppressed"])
def test_filters_equal_jax(env, wd, case):
    args = ["--scanners", "misconfig,secret"]
    if case == "severity":
        args += ["--severity", "CRITICAL,HIGH"]
    elif case == "ignorefile":
        (wd / ".trivyignore").write_text("DS002\nKSV017\n")
        args += ["--show-suppressed"]
    elif case == "yaml-ignorefile":
        (wd / "ignore.yaml").write_text(
            "misconfigurations:\n  - id: DS001\n    paths: [svc/Dockerfile]\n"
            "    statement: base pinned elsewhere\n")
        args += ["--ignorefile", "ignore.yaml", "--show-suppressed"]
    else:
        (wd / "policy.py").write_text(
            "def ignore_misconfiguration(m):\n    return m['Severity'] == 'LOW'\n")
        args += ["--ignore-policy", "policy.py"]
        if case == "policy-suppressed":
            args += ["--show-suppressed"]
    mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], *args)
    assert rc1 == rc2 == 0
    doc = assert_json_equal(mine, ref)
    sevs = {m["Severity"] for r in doc["Results"] for m in r.get("Misconfigurations", [])}
    if case == "severity":
        assert sevs <= {"CRITICAL", "HIGH"} and sevs
    if case.startswith("policy"):
        assert "LOW" not in sevs
    if "suppressed" in case or "ignorefile" in case:
        assert any(r.get("ExperimentalModifiedFindings") for r in doc["Results"])
    table_mine, table_ref, _, _ = run_both(wd, "fs", env["tree"], *args, fmt="table")
    assert table_mine == table_ref


@pytest.mark.parametrize("source", ["cli", "env", "config"])
def test_config_check_and_scanners_from_every_source(env, wd, monkeypatch, source):
    """``--config-check`` (a Python and a Rego file) and
    ``--misconfig-scanners`` from the command line, the environment and the
    config file: the custom checks' findings, equal to the JAX CLI's."""
    args = []
    if source == "cli":
        args = ["--config-check", str(env["checks"]), "--misconfig-scanners",
                "kubernetes,yaml,json"]
    elif source == "env":
        monkeypatch.setenv("TRIVY_TPU_CONFIG_CHECK", str(env["checks"]))
        monkeypatch.setenv("TRIVY_TPU_MISCONFIG_SCANNERS", "kubernetes,yaml,json")
    else:
        (wd / "trivy-tpu.yaml").write_text(
            f"misconfiguration:\n  config-check: [{env['checks']}]\n"
            "  scanners: [kubernetes, yaml, json]\n")
    mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", "misconfig", *args)
    assert rc1 == rc2 == 0
    fails = failed_ids(assert_json_equal(mine, ref))
    assert "USR-PY-001" in fails["config/values.yaml"] | fails["config/settings.json"]
    assert "USR-K8S-100" in fails["deploy/d.yaml"]
    assert not any(t.startswith("svc/") for t in fails)  # dockerfile left out


CFN_AND_CHART = {
    "cfn/stack.json": b'{"Resources": {"B": {"Type": "AWS::S3::Bucket"}}}',
    "cfn/stack.yaml": b"AWSTemplateFormatVersion: '2010-09-09'\nResources:\n  B:\n"
                      b"    Type: AWS::S3::Bucket\n    Properties:\n      AccessControl: "
                      b"PublicRead\n",
    "chart/Chart.yaml": b"apiVersion: v2\nname: c\nversion: 0.1.0\n",
    "chart/values.yaml": b"privileged: true\n",
    "chart/templates/pod.yaml": MANIFESTS["c.yaml"].replace(
        b"privileged: true", b"privileged: {{ .Values.privileged }}"),
}


@pytest.fixture(scope="module")
def iac_tree(env):
    """The tree with a CloudFormation stack in each syntax and a chart."""
    tree = env["base"] / "iac"
    if not tree.exists():
        shutil.copytree(env["tree"], tree)
        write_tree(tree, CFN_AND_CHART)
    return tree


@pytest.mark.parametrize("source", ["cli", "env", "config"])
@pytest.mark.parametrize("ftype", ["cloudformation", "helm"])
def test_a_named_cloudformation_or_helm_type_equals_jax(iac_tree, wd, monkeypatch, source,
                                                        ftype):
    """The settings that exited 2 before the two types were ported: named
    from the command line (beside ``dockerfile``), the environment or the
    config file, each gives the JAX CLI's report of that type."""
    args = []
    want = {ftype}
    if source == "cli":
        args = ["--misconfig-scanners", f"dockerfile,{ftype}"]
        want = {"dockerfile", ftype}
    elif source == "env":
        monkeypatch.setenv("TRIVY_TPU_MISCONFIG_SCANNERS", ftype)
    else:
        (wd / "trivy-tpu.yaml").write_text(f"misconfiguration:\n  scanners: [{ftype}]\n")
    mine, ref, rc1, rc2 = run_both(wd, "fs", iac_tree, "--scanners", "misconfig", *args)
    assert rc1 == rc2 == 0
    doc = assert_json_equal(mine, ref)
    assert {r["Type"] for r in doc["Results"] if r["Class"] == "config"} == want


@pytest.mark.parametrize("rel,content", [
    ("cfn/stack.json", CFN_AND_CHART["cfn/stack.json"]),
    ("cfn/stack.yaml", CFN_AND_CHART["cfn/stack.yaml"]),
    ("chart/Chart.yaml", CFN_AND_CHART["chart/Chart.yaml"]),
])
def test_a_cloudformation_or_helm_file_met_by_default_equals_jax(env, wd, tmp_path, rel,
                                                                 content):
    """The files that stopped a default scan before: met by a default
    ``misconfig,secret`` scan, left out by ``--misconfig-scanners`` and
    with ``secret`` alone, each report equals the JAX CLI's."""
    tree = tmp_path / "t"
    shutil.copytree(env["tree"], tree)
    write_tree(tree, {rel: content})
    mine, ref, rc1, rc2 = run_both(wd, "fs", tree, "--scanners", "misconfig,secret")
    assert rc1 == rc2 == 0
    assert_json_equal(mine, ref)
    mine, ref, rc1, rc2 = run_both(wd, "fs", tree, "--scanners", "misconfig,secret",
                                   "--misconfig-scanners", "dockerfile,kubernetes,yaml,json")
    assert rc1 == rc2 == 0
    assert rel not in failed_ids(assert_json_equal(mine, ref))
    mine, ref, rc1, rc2 = run_both(wd, "fs", tree, "--scanners", "secret")
    assert rc1 == rc2 == 0
    assert_json_equal(mine, ref)


def test_incremental_keys_and_findings_equal_jax(env, wd, tmp_path, monkeypatch):
    """``--incremental``, ``--since-last`` and ``--diff-base`` with
    ``misconfig``: the reports, reuse counts and unit keys equal the JAX
    ones; an edited manifest re-analyzes its unit alone, a committed tree
    is keyed from git, and ``--config-check`` changes every key."""
    from trivy_tpu.incremental.fs import IncrementalFSArtifact as JaxArtifact

    seen = []
    real = JaxArtifact.inspect

    def inspect(self):
        ref = real(self)
        seen.append(self.last_stats)
        return ref

    monkeypatch.setattr(JaxArtifact, "inspect", inspect)
    tree = tmp_path / "t"
    shutil.copytree(env["tree"], tree)
    stats = wd / "stats.json"

    def step(*flags):
        outs = []
        for tag, main, dev in (("port", cli.main, ["--device", "cpu", "--stats-out",
                                                   str(stats)]),
                               ("jax", jax_cli.main, ["--backend", "cpu"])):
            out = wd / f"{tag}.json"
            assert main(["fs", *dev, "--format", "json", "-o", str(out), "-q", "--cache-dir",
                         str(wd / f"c-{tag}"), "--scanners", "misconfig,secret", *flags,
                         str(tree)]) == 0
            outs.append(out.read_text())
        assert_json_equal(*outs)
        st = json.loads(stats.read_text())
        keys = hashlib.sha256("\n".join(sorted(seen[-1]["unit_keys"])).encode()).hexdigest()
        assert st["unit_set"] == keys
        assert st["units_analyzed"] == seen[-1]["units_analyzed"]
        return st

    first = step("--incremental")
    assert first["units_analyzed"] == first["units_total"] > 1
    assert step("--since-last")["units_analyzed"] == 0
    (tree / "deploy" / "s.yaml").write_bytes(MANIFESTS["d.yaml"])
    assert step("--since-last")["units_analyzed"] == 1
    for args in (["init", "-q"], ["add", "-A"], ["-c", "user.email=a@b", "-c", "user.name=a",
                                                  "commit", "-q", "-m", "base"]):
        subprocess.run(["git", *args], cwd=tree, check=True, capture_output=True)
    step("--since-last")
    diffed = step("--diff-base", "HEAD")
    assert diffed["units_analyzed"] == 0 and diffed["files_git_reused"] > 0
    checked = step("--incremental", "--config-check", str(env["checks"]))
    assert checked["unit_set"] != first["unit_set"]


@pytest.mark.parametrize("client,server_kind", [("port", "jax"), ("jax", "port"),
                                                ("port", "port")])
def test_client_mode_across_packages(env, wd, client, server_kind):
    from trivy_tpu.rpc.server import start_server as jax_start_server
    from trivy_tpu_torch.rpc.server import start_server

    local, ref_local, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", SCANNERS)
    assert rc1 == rc2 == 0
    if server_kind == "port":
        httpd, port = start_server(cache=new_cache("memory"), device="cpu")
    else:
        httpd, port = jax_start_server(cache_dir=str(wd / "jax-srv"))
    try:
        out = wd / "remote.json"
        main, dev = ((cli.main, ["--device", "cpu"]) if client == "port"
                     else (jax_cli.main, ["--backend", "cpu"]))
        assert main(["fs", "--scanners", SCANNERS, *dev, "--format", "json", "-o", str(out),
                     "-q", "--cache-dir", str(wd / "cc"), "--server",
                     f"http://127.0.0.1:{port}", str(env["tree"])]) == 0
    finally:
        httpd.shutdown()
    got = assert_json_equal(out.read_text(), local)
    assert failed_ids(got)


def test_fleet_with_misconfig_equals_the_local_scan(env, iac_tree, wd):
    """``--fleet`` with ``misconfig,secret`` on ``fs`` and ``image`` (the
    commands that exited 2 before), over two port replicas: the local
    scan's ``Results``."""
    from tests.test_torch_fleet_replica import port_server

    servers = [port_server() for _ in range(2)]
    hosts = ",".join(f"127.0.0.1:{port}" for _, port in servers)
    try:
        for command, target in (("fs", iac_tree), ("image", env["image"])):
            local, _, rc, _ = run_both(wd, command, target, "--scanners", "misconfig,secret")
            assert rc == 0
            out = wd / "fleet.json"
            assert cli.main([command, "--scanners", "misconfig,secret", "--device", "cpu",
                             "--format", "json", "-q", "--cache-dir", str(wd / "cf"),
                             "--fleet", hosts, "--fleet-speculate", "0",
                             "--fleet-telemetry-interval", "0", "--fleet-split-threshold", "0",
                             "-o", str(out), str(target)]) == 0
            assert failed_ids(assert_json_equal(out.read_text(), local))
    finally:
        for httpd, _ in servers:
            httpd.shutdown()


def test_a_misconfig_shard_equals_the_jax_replicas(env):
    """The shard that answered 400: run by the port's executor and by the
    JAX one, it gives the same key and blob, and a port server answers it
    with 200."""
    from trivy_tpu.cache import new_cache as jax_new_cache
    from trivy_tpu.fleet import plan as jax_plan
    from trivy_tpu_torch.fleet.plan import check_shard, execute_shard
    from trivy_tpu_torch.rpc.server import start_server

    shard = {"Kind": "fs", "Root": str(env["tree"]), "Paths": ["svc/Dockerfile",
                                                               "deploy/c.yaml"],
             "Scanners": ["misconfig", "secret"], "Backend": "cpu"}
    check_shard(shard)
    mine = execute_shard(shard, new_cache("memory"), device="cpu")
    ref = jax_plan.execute_shard(shard, jax_new_cache("memory", None))
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(ref))
    assert mine[0]["BlobInfo"]["Misconfigurations"]
    httpd, port = start_server(cache=new_cache("memory"), device="cpu")
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/twirp/trivy.scanner.v1.Scanner/Scan",
            data=json.dumps({"Target": "t", "ArtifactID": "a", "BlobIDs": [],
                             "Options": {"Scanners": ["misconfig"]}, "Shard": shard}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            assert json.loads(r.read())["Blobs"] == json.loads(json.dumps(mine))
    finally:
        httpd.shutdown()
