"""Terraform, terraform plans and ARM templates through the port's CLI
against ``python -m trivy_tpu.cli … --backend cpu``, on the CPU, on one
seeded monorepo (``tests/tftree.py``: modules called from environment
roots with ``count``, ``for_each`` and ``.tfvars``, ``.tf.json``, every
provider, a plan and two ARM templates, a planted token): ``fs --scanners
misconfig,secret`` in JSON, table and SARIF; ``--misconfig-scanners``;
a custom ``cloud_check`` through ``--config-check``; ``image`` with the
tree in a layer; an incremental rescan after an edit in a called module;
CloudFormation and Helm beside Terraform, named or met; and ``--fleet``
against the JAX fleet.
"""

from __future__ import annotations

import json
import shutil

import pytest

from tests.imagetest import docker_save_tar, tar_bytes
from tests.secret_samples import SAMPLES
from tests.test_iac import CUSTOM_CHECK
from tests.test_torch_match import few_torch_threads  # noqa: F401
from tests.test_torch_misconf import _clean_custom_checks  # noqa: F401  (autouse)
from tests.test_torch_misconf_cli import (  # noqa: F401  (the wd fixture)
    DOCKERFILES,
    assert_json_equal,
    failed_ids,
    run_both,
    wd,
    write_tree,
)
from tests.tftree import write_tf_monorepo
from trivy_tpu import cli as jax_cli
from trivy_tpu.misconf.checks import checks_for as jax_checks_for
from trivy_tpu_torch import cli

SCANNERS = "misconfig,secret"
# the ids a seeded tree of every provider reports
EXPECTED_IDS = {"AVD-AWS-0107", "AVD-AZU-0008", "AVD-GCP-0002"}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("terraform-cli")
    tree = base / "tree"
    write_tf_monorepo(tree, 3, modules=6, envs=2, blocks=3, plan_bytes=24 << 10,
                      secrets={"github": SAMPLES["github-pat"]})
    write_tree(tree, {"svc/Dockerfile": DOCKERFILES["Dockerfile"]})
    files = {str(p.relative_to(tree)): p.read_bytes() for p in tree.rglob("*") if p.is_file()}
    layer0 = tar_bytes({"etc/alpine-release": b"3.19.1\n"})
    layer1 = tar_bytes({f"infra/{k}": v for k, v in files.items()})
    image = docker_save_tar(base / "img.tar", [layer0, layer1])
    checks = base / "checks"
    checks.mkdir()
    (checks / "cloud.py").write_text(CUSTOM_CHECK)
    # the JAX registry loaded once in this process: the JAX package reads
    # it half loaded when an image's layers first use it at once
    jax_checks_for("dockerfile")
    return {"base": base, "tree": tree, "image": image, "checks": checks}


def file_types(doc: dict) -> set:
    return {r["Type"] for r in doc["Results"] if r["Class"] == "config"}


def test_json_equals_jax(env, wd):
    mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", SCANNERS)
    assert rc1 == rc2 == 0
    doc = assert_json_equal(mine, ref)
    fails = set().union(*failed_ids(doc).values())
    assert EXPECTED_IDS <= fails
    assert file_types(doc) == {"terraform", "terraformplan-json", "azure-arm", "dockerfile"}
    assert any(r["Class"] == "secret" and r["Target"].endswith("terraform.tfvars")
               for r in doc["Results"])


@pytest.mark.parametrize("fmt", ["table", "sarif"])
def test_table_and_sarif_bytes_equal_jax(env, wd, fmt):
    mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", SCANNERS, fmt=fmt)
    assert rc1 == rc2 == 0 and mine == ref
    assert "AVD-AWS-0107" in mine


@pytest.mark.parametrize("types,want", [
    ("terraform", {"terraform"}),
    ("azure-arm,dockerfile", {"azure-arm", "dockerfile"}),
])
def test_misconfig_scanners_equal_jax(env, wd, types, want):
    mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", "misconfig",
                                   "--misconfig-scanners", types)
    assert rc1 == rc2 == 0
    assert file_types(assert_json_equal(mine, ref)) == want


def test_a_plan_is_no_misconfig_scanners_choice_as_in_jax(env, wd, capsys):
    """``terraformplan-json`` is no choice of the JAX flag: naming it exits 2
    in both CLIs, and a plan is scanned only when no type is named."""
    for main, dev in ((cli.main, ["--device", "cpu"]), (jax_cli.main, ["--backend", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(["fs", *dev, "--scanners", "misconfig", "-o", str(wd / "out.json"),
                  "--misconfig-scanners", "terraformplan-json,azure-arm", str(env["tree"])])
        assert exc.value.code == 2 and "terraformplan-json" in capsys.readouterr().err
    assert not (wd / "out.json").exists()


def test_custom_cloud_check_equals_jax(env, wd):
    mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", "misconfig",
                                   "--config-check", str(env["checks"]))
    assert rc1 == rc2 == 0
    fails = failed_ids(assert_json_equal(mine, ref))
    assert any("TEST-USR-02" in ids for ids in fails.values())


def test_image_with_terraform_in_a_layer_equals_jax(env, wd):
    mine, ref, rc1, rc2 = run_both(wd, "image", env["image"], "--scanners", SCANNERS)
    assert rc1 == rc2 == 0
    doc = assert_json_equal(mine, ref)
    assert EXPECTED_IDS <= set().union(*failed_ids(doc).values())
    assert any(t.startswith("infra/modules/") for t in failed_ids(doc))


def test_incremental_rescan_after_a_module_edit_equals_jax(env, wd, tmp_path):
    """An edit in a module that an environment root calls: each package's
    ``--since-last`` rescan re-analyzes what it re-analyzes, and the two
    reports are equal, before and after."""
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
                         str(wd / f"c-{tag}"), "--scanners", SCANNERS, *flags,
                         str(tree)]) == 0
            outs.append(out.read_text())
        return assert_json_equal(*outs), json.loads(stats.read_text())

    first, st = step("--incremental")
    assert st["units_analyzed"] == st["units_total"] > 1
    _, st = step("--since-last")
    assert st["units_analyzed"] == 0
    (called,) = [p for p in (tree / "modules").iterdir() if p.name.startswith("m01-")]
    main_tf = called / "main.tf"
    main_tf.write_text(main_tf.read_text() + 'resource "aws_s3_bucket" "edited" {\n'
                       '  bucket = "${var.name}-edited"\n  acl    = "public-read"\n}\n')
    edited, st = step("--since-last")
    assert 0 < st["units_analyzed"] < st["units_total"]
    assert edited != first
    # a fault of the reference, which the port keeps: the rescan evaluates
    # the edited module's unit apart from the rest of the set, so its files
    # lose the results that the whole set gives them (ROADMAP Queue C)
    full, _ = step()
    assert edited["Results"] != full["Results"]
    targets = {r["Target"] for r in full["Results"]
               if r not in edited["Results"] and r["Class"] == "config"}
    assert targets and all(t.startswith(str(called.relative_to(tree))) for t in targets)


def test_cloudformation_and_helm_beside_terraform_equal_jax(env, wd, tmp_path):
    """The inputs that exited 2 before the two types were ported: named
    beside ``terraform``, and a stack or a chart met in the Terraform tree
    by a default scan and left out by ``--misconfig-scanners``, each report
    equals the JAX CLI's."""
    for ftype in ("cloudformation", "helm"):
        mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", "misconfig",
                                       "--misconfig-scanners", f"terraform,{ftype}")
        assert rc1 == rc2 == 0
        assert file_types(assert_json_equal(mine, ref)) == {"terraform"}
    for rel, content, ftype in (
            ("cfn/stack.yaml", b"AWSTemplateFormatVersion: '2010-09-09'\n"
                               b"Resources:\n  B:\n    Type: AWS::S3::Bucket\n",
             "cloudformation"),
            ("chart/Chart.yaml", b"apiVersion: v2\nname: c\nversion: 0.1.0\n", None)):
        tree = tmp_path / rel.split("/")[0]
        shutil.copytree(env["tree"], tree)
        write_tree(tree, {rel: content})
        mine, ref, rc1, rc2 = run_both(wd, "fs", tree, "--scanners", SCANNERS)
        assert rc1 == rc2 == 0
        types = file_types(assert_json_equal(mine, ref))
        assert "terraform" in types and (ftype is None or ftype in types)
        mine, ref, rc1, rc2 = run_both(wd, "fs", tree, "--scanners", "misconfig",
                                       "--misconfig-scanners", "terraform,azure-arm")
        assert rc1 == rc2 == 0
        assert file_types(assert_json_equal(mine, ref)) == {"terraform", "azure-arm"}


def test_fleet_with_misconfig_equals_the_jax_fleet(env, wd):
    """``--fleet`` with ``misconfig,secret`` over the monorepo: the port's
    coordinator over port replicas gives the JAX coordinator's report over
    JAX replicas. The shards cut the environment roots away from the
    modules they call, so each shard evaluates its part of the set alone:
    where that differs from the local scan, it is the reference's fault of
    an incremental rescan (ROADMAP Queue C), and it differs in Terraform
    results only."""
    from tests.test_torch_helm import FLEET, jax_replica, port_replica

    reports = []
    for main, dev, make in ((cli.main, ["--device", "cpu"], port_replica),
                            (jax_cli.main, ["--backend", "cpu"], jax_replica)):
        servers = [make(True) for _ in range(2)]
        try:
            out = wd / "fleet.json"
            assert main(["fs", *dev, "--format", "json", "-o", str(out), "-q", "--cache-dir",
                         str(wd / f"cf{len(reports)}"), "--scanners", SCANNERS, "--fleet",
                         ",".join(f"127.0.0.1:{port}" for _, port in servers), *FLEET,
                         str(env["tree"])]) == 0
            reports.append(out.read_text())
        finally:
            for httpd, _ in servers:
                httpd.shutdown()
    fleet = assert_json_equal(*reports)
    local, _, rc, _ = run_both(wd, "fs", env["tree"], "--scanners", SCANNERS)
    assert rc == 0
    local = json.loads(local)
    differ = [r for r in fleet["Results"] + local["Results"]
              if (r in fleet["Results"]) != (r in local["Results"])]
    assert all(r["Type"] == "terraform" for r in differ)
    assert EXPECTED_IDS <= set().union(*failed_ids(fleet).values())
