"""The ``k8s`` command of the port (``trivy_tpu_torch/k8s.py``,
``k8s_node.py`` and the CLI's ``k8s`` branch) against the JAX package, on
the CPU, with exact equality:

- manifests and cluster dumps load to the same documents (files,
  directories, ``List`` objects, multi-document YAML, JSON), and a dump
  that does not load fails with the JAX message;
- the workload rows (misconfigurations and secrets per resource), the
  ``NodeInfo`` node checks, the images of the pod specs, and the summary
  in ``table`` and ``json``;
- ``k8s --manifests`` on a dump of about twenty workloads with a
  ``NodeInfo``, in both formats, with and without ``--compliance``;
- a cluster through a fake ``kubectl`` first on ``PATH`` (its output, its
  failure, and no ``kubectl`` at all: exit 1, "kubectl not found");
- ``--scan-images`` against the in-process registry of
  ``tests/registrytest.py`` with the fixture DB, and an image that cannot
  be pulled (an error row).
"""

from __future__ import annotations

import json
import os
import random
import stat

import pytest

from tests.dbtest import build_db
from tests.imagetest import tar_bytes
from tests.registrytest import MemoryRegistry, start_registry
from tests.secret_samples import SAMPLES
from tests.test_k8s_node import GOOD_INFO
from tests.test_torch_match import few_torch_threads, port_logs_propagate  # noqa: F401
from tests.test_torch_misconf import _clean_custom_checks  # noqa: F401  (autouse)
from trivy_tpu import cli as jax_cli
from trivy_tpu import k8s as jax_k8s
from trivy_tpu import k8s_node as jax_k8s_node
from trivy_tpu.misconf.checks import checks_for as jax_checks_for
from trivy_tpu_torch import cli, k8s, k8s_node

KINDS = ["Pod", "Deployment", "StatefulSet", "DaemonSet", "ReplicaSet", "Job", "CronJob"]


def node_doc(info: dict, name: str) -> dict:
    return {"apiVersion": "v1", "kind": "NodeInfo", "type": "node-collector",
            "metadata": {"name": name}, "info": info}


def pod_spec(rng: random.Random, image: str, i: int) -> dict:
    c = {"name": f"c{i}", "image": image}
    if rng.random() < 0.4:
        c["securityContext"] = {"privileged": True}
    if rng.random() < 0.4:
        c["securityContext"] = {"runAsNonRoot": True, "allowPrivilegeEscalation": False,
                                "readOnlyRootFilesystem": True,
                                "capabilities": {"drop": ["ALL"]}}
    if rng.random() < 0.3:
        c["env"] = [{"name": "TOKEN", "value": SAMPLES["github-pat"]}]
    spec = {"containers": [c]}
    if rng.random() < 0.3:
        spec["hostNetwork"] = True
    if rng.random() < 0.2:
        spec["initContainers"] = [{"name": "init", "image": "busybox:1.36"}]
    return spec


def workload(rng: random.Random, i: int, images: list[str]) -> dict:
    kind = KINDS[i % len(KINDS)]
    spec = pod_spec(rng, images[i % len(images)], i)
    body = {"Pod": spec,
            "CronJob": {"schedule": "*/5 * * * *",
                        "jobTemplate": {"spec": {"template": {"spec": spec}}}}}.get(
        kind, {"template": {"metadata": {"labels": {"app": f"w{i}"}}, "spec": spec}})
    return {"apiVersion": "batch/v1" if kind in ("Job", "CronJob") else
            ("v1" if kind == "Pod" else "apps/v1"),
            "kind": kind,
            "metadata": {"name": f"w{i:02d}", "namespace": rng.choice(["default", "prod",
                                                                       "kube-system"])},
            "spec": body}


def write_dump(root, seed: int, images: list[str], n: int = 20) -> dict:
    """A dump of ``n`` workloads across three files (a ``List`` in JSON,
    multi-document YAML, a bare manifest), two ``NodeInfo`` documents (one
    passing, one failing) and a Service (no workload)."""
    rng = random.Random(seed)
    docs = [workload(rng, i, images) for i in range(n)]
    bad = {**GOOD_INFO, "kubeletAnonymousAuthArgumentSet": {"values": ["true"]},
           "kubeletConfFilePermissions": {"values": [777]}}
    root.mkdir(parents=True, exist_ok=True)
    (root / "list.json").write_text(json.dumps(
        {"apiVersion": "v1", "kind": "List",
         "items": docs[: n // 2] + [node_doc(GOOD_INFO, "worker-1"),
                                    node_doc(bad, "worker-2")]}))
    import yaml

    (root / "more.yaml").write_text(yaml.safe_dump_all(
        docs[n // 2: n - 1] + [{"apiVersion": "v1", "kind": "Service",
                                "metadata": {"name": "svc"}, "spec": {}}]))
    (root / "sub").mkdir(exist_ok=True)
    (root / "sub" / "last.yml").write_text(yaml.safe_dump(docs[n - 1]))
    (root / "notes.txt").write_text("not a manifest\n")
    return {"docs": docs}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("k8s")
    dump = base / "dump"
    write_dump(dump, 3, ["nginx:1.25", "busybox:latest", "registry.example/app:2"])
    jax_checks_for("dockerfile")  # the JAX registry loaded whole, once
    return {"base": base, "dump": dump}


def rows_json(rows):
    return json.loads(json.dumps(rows, default=lambda o: o.to_dict()))


@pytest.mark.parametrize("what", ["dir", "list.json", "more.yaml", "sub/last.yml"])
def test_manifests_load_as_in_jax(env, what):
    path = str(env["dump"] if what == "dir" else env["dump"] / what)
    mine = k8s.load_manifests(path)
    assert mine == jax_k8s.load_manifests(path) and mine


def test_a_dump_that_does_not_load_fails_as_in_jax(tmp_path):
    (tmp_path / "a.json").write_text("{not json")
    (tmp_path / "b.yaml").write_text("a: [1,\n")
    errors = []
    for load in (k8s.load_manifests, jax_k8s.load_manifests):
        with pytest.raises(RuntimeError) as exc:
            load(str(tmp_path))
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "no parseable manifests" in errors[0]


def test_workload_rows_equal_jax(env):
    docs = k8s.load_manifests(str(env["dump"]))
    mine = rows_json(k8s.scan_workloads(docs))
    assert mine == rows_json(jax_k8s.scan_workloads(docs))
    assert {r["kind"] for r in mine} == set(KINDS) | {"NodeInfo"}
    assert len(mine) == 22 and any(r["secrets"] for r in mine if "secrets" in r)
    assert k8s.workload_images(docs) == jax_k8s.workload_images(docs)


@pytest.mark.parametrize("case", ["good", "bad", "empty-key", "modes", "named-by-nodeName",
                                  "no-info"])
def test_node_checks_equal_jax(case):
    info = {"good": GOOD_INFO,
            "bad": {**GOOD_INFO, "kubeletReadOnlyPortArgumentSet": {"values": ["10255"]},
                    "kubeletAuthorizationModeArgumentSet": {"values": ["AlwaysAllow"]}},
            "empty-key": {"kubeletClientCaFileArgumentSet": {"values": []}},
            "modes": {"kubeletConfFilePermissions": {"values": [640]},
                      "kubeletServiceFilePermissions": {"values": ["x"]},
                      "kubeletEventQpsArgumentSet": {"values": ["nan-ish"]}},
            "named-by-nodeName": GOOD_INFO, "no-info": None}[case]
    doc = node_doc(info or {}, "n1")
    if case == "named-by-nodeName":
        doc["nodeName"] = "from-field"
    if case == "no-info":
        doc.pop("info")
    assert k8s_node.is_node_info(doc) == jax_k8s_node.is_node_info(doc) is True
    assert (k8s_node.scan_node_info(doc).to_dict()
            == jax_k8s_node.scan_node_info(doc).to_dict())
    docs = [doc, {"kind": "Pod"}]
    assert ([m.to_dict() for m in k8s_node.scan_nodes(docs)]
            == [m.to_dict() for m in jax_k8s_node.scan_nodes(docs)])
    assert [(c.id, c.op) for c in k8s_node.NODE_CHECKS] == [
        (c.id, c.op) for c in jax_k8s_node.NODE_CHECKS]


def run_both(wd, *args):
    """``k8s`` of both CLIs: (port output, JAX output, exit codes)."""
    outs, rcs = [], []
    for tag, main, dev in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        out = wd / f"{tag}.out"
        out.unlink(missing_ok=True)
        rcs.append(main(["k8s", *dev, "-o", str(out), *args]))
        outs.append(out.read_text() if out.exists() else None)
    return outs[0], outs[1], rcs[0], rcs[1]


@pytest.mark.parametrize("compliance", [None, "k8s-nsa-1.0", "k8s-cis-1.23"])
@pytest.mark.parametrize("fmt", ["table", "json"])
def test_k8s_manifests_equal_jax(env, tmp_path, fmt, compliance):
    args = ["--manifests", str(env["dump"]), "--format", fmt]
    if compliance:
        args += ["--compliance", compliance]
    mine, ref, rc1, rc2 = run_both(tmp_path, *args)
    assert rc1 == rc2 == 0 and mine == ref
    if fmt == "json" and compliance is None:
        kinds = {r["Kind"] for r in json.loads(mine)["Resources"]}
        assert "NodeInfo" in kinds and "CronJob" in kinds
    if compliance == "k8s-cis-1.23" and fmt == "json":
        statuses = {c["ID"]: c["Status"] for c in json.loads(mine)["Results"]}
        assert statuses["4.2.1"] == "FAIL"


def test_an_unknown_spec_exits_1_as_in_jax(env, tmp_path):
    mine, ref, rc1, rc2 = run_both(tmp_path, "--manifests", str(env["dump"]),
                                   "--compliance", "no-such-spec")
    assert rc1 == rc2 == 1 and mine is None and ref is None


KUBECTL = """#!{python}
import sys
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
{body}
"""


def fake_kubectl(bindir, body: str, log) -> None:
    import sys

    bindir.mkdir(exist_ok=True)
    path = bindir / "kubectl"
    path.write_text(KUBECTL.format(python=sys.executable, log=str(log), body=body))
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


@pytest.mark.parametrize("case", ["dump", "context", "fails", "bad-json", "missing"])
def test_a_cluster_through_kubectl_equals_jax(env, tmp_path, monkeypatch, caplog,
                                            port_logs_propagate, case):
    """``k8s`` without ``--manifests`` runs ``kubectl get`` from ``PATH``:
    a fake one prints the dump's ``List``, fails, or prints no JSON; with
    none on ``PATH`` both CLIs exit 1 with "kubectl not found"."""
    bindir, log = tmp_path / "bin", tmp_path / "kubectl.log"
    dump = env["dump"] / "list.json"
    body = {"dump": f"print(open({str(dump)!r}).read())",
            "context": f"print(open({str(dump)!r}).read())",
            "fails": "sys.stderr.write('the server has asked for credentials\\n'); sys.exit(3)",
            "bad-json": "print('{nope')", "missing": ""}[case]
    if case != "missing":
        fake_kubectl(bindir, body, log)
    else:
        bindir.mkdir()
    monkeypatch.setenv("PATH", str(bindir) + ("" if case == "missing" else
                                              os.pathsep + os.environ["PATH"]))
    args = ["--format", "json"] + (["--context", "prod-eu"] if case == "context" else [])
    mine, ref, rc1, rc2 = run_both(tmp_path, *args)
    if case in ("dump", "context"):
        assert rc1 == rc2 == 0 and mine == ref
        assert {r["Kind"] for r in json.loads(mine)["Resources"]} >= {"NodeInfo", "Pod"}
        calls = log.read_text().splitlines()
        assert len(calls) == 2 and calls[0] == calls[1]
        assert calls[0].startswith("get pods,deployments,statefulsets,daemonsets,replicasets,"
                                   "jobs,cronjobs -A -o json")
        assert ("--context prod-eu" in calls[0]) == (case == "context")
    else:
        assert rc1 == rc2 == 1 and mine is None and ref is None
        want = {"fails": "kubectl failed: the server has asked for credentials",
                "bad-json": "kubectl produced invalid JSON",
                "missing": "kubectl not found"}[case]
        assert [r.name for r in caplog.records if want in r.getMessage()] == [
            "trivy_tpu_torch.cli", "trivy_tpu.cli"]


# -- --scan-images against the in-process registry ----------------------------------


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """``localhost:<port>`` serving two images: an alpine base with a
    vulnerable ``musl`` and a planted token, and a clean one."""
    reg = MemoryRegistry()
    reg.add_image("apps/web", "v1", [
        tar_bytes({"etc/alpine-release": b"3.18.4\n",
                   "lib/apk/db/installed": b"P:musl\nV:1.2.3-r0\n\nP:busybox\nV:1.36.0-r0\n\n"}),
        tar_bytes({"app/config.py": f"token = '{SAMPLES['github-pat']}'\n".encode()})])
    reg.add_image("apps/clean", "v2", [tar_bytes({"etc/alpine-release": b"3.18.4\n",
                                                   "app/main.py": b"print('hi')\n"})])
    httpd, host = start_registry(reg)
    base = tmp_path_factory.mktemp("k8s-images")
    yield {"host": host, "db": build_db(base), "base": base}
    httpd.shutdown()


@pytest.mark.parametrize("with_db", [True, False])
def test_scan_images_equals_jax(registry, tmp_path, with_db):
    host = registry["host"]
    dump = tmp_path / "dump"
    write_dump(dump, 9, [f"{host}/apps/web:v1", f"{host}/apps/clean:v2",
                         "localhost:1/gone/app:1"], n=8)
    args = ["--manifests", str(dump), "--scan-images", "--insecure", "--db-repository",
            registry["db"] if with_db else str(tmp_path / "no-db")]
    mine, ref, rc1, rc2 = run_both(tmp_path, *args, "--format", "json")
    assert rc1 == rc2 == 0
    a, b = json.loads(mine), json.loads(ref)
    assert a == b
    rows = {r["Image"]: r for r in a["Images"]}
    web = rows[f"{host}/apps/web:v1"]
    ids = {f.get("VulnerabilityID") or f.get("RuleID") for f in web["Findings"]}
    assert "github-pat" in ids
    assert ("CVE-2023-0001" in ids) == with_db
    assert rows["localhost:1/gone/app:1"]["Error"]
    table, ref_table, rc1, rc2 = run_both(tmp_path, *args, "--format", "table")
    assert rc1 == rc2 == 0 and table == ref_table and "Workload Images" in table
