"""``--compliance`` in the port (``trivy_tpu_torch/compliance``, the CLI's
report branch) against the JAX package, on the CPU, with exact equality:

- every builtin spec and a ``@spec.yaml`` load to the same controls, and
  ``apply_spec`` gives the same statuses and findings on the same reports;
- ``fs``, ``image`` and ``sbom`` with ``--compliance`` write the JAX
  CLI's bytes in ``table`` and ``json``, for each builtin spec;
- ``--compliance`` reads the filtered report (``--severity``, the ignore
  file); ``--exit-code`` applies when a control fails;
- the refusals exit with the JAX codes: another format, an unknown spec
  or a spec file that does not load exits 2, with no report.
"""

from __future__ import annotations

import json

import pytest

from tests.dbtest import build_db
from tests.iactree import write_iac_tree
from tests.imagetest import docker_save_tar, tar_bytes
from tests.secret_samples import SAMPLES
from tests.test_torch_cloudformation import norm
from tests.test_torch_match import few_torch_threads  # noqa: F401
from tests.test_torch_misconf import _clean_custom_checks  # noqa: F401  (autouse)
from tests.test_torch_misconf_cli import wd  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu import compliance as jax_compliance
from trivy_tpu import types as jax_types
from trivy_tpu.misconf.checks import checks_for as jax_checks_for
from trivy_tpu_torch import cli, compliance, types

SPECS = sorted(jax_compliance.BUILTIN_SPECS)
USER_SPEC = """spec:
  id: acme-baseline
  title: ACME baseline
  version: "2"
  description: the checks ACME requires
  controls:
    - id: "1"
      name: No privileged containers
      severity: HIGH
      checks: [{id: KSV017}]
    - id: "2"
      name: No public buckets
      checks: [{id: AVD-AWS-0088}, {id: AVD-AWS-0092}]
    - id: "3"
      name: No leaked tokens
      severity: CRITICAL
      checks: [{id: github-pat}, {id: aws-access-key-id}]
    - id: "4"
      name: Known CVEs
      checks: [{id: CVE-2023-0001}]
    - id: "5"
      name: Reviewed by hand
      defaultStatus: MANUAL
    - id: "6"
      name: Never fails
      checks: [{id: NO-SUCH-CHECK}]
"""


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("compliance")
    tree = base / "tree"
    write_iac_tree(tree, 5, secrets={"github": SAMPLES["github-pat"]})
    (tree / "etc").mkdir()
    (tree / "etc" / "alpine-release").write_text("3.18.4\n")
    (tree / "lib" / "apk" / "db").mkdir(parents=True)
    (tree / "lib" / "apk" / "db" / "installed").write_text("P:musl\nV:1.2.3-r0\n\n")
    files = {str(p.relative_to(tree)): p.read_bytes() for p in tree.rglob("*") if p.is_file()}
    image = docker_save_tar(base / "img.tar", [tar_bytes(files)])
    bom = base / "bom.json"
    bom.write_text(json.dumps({"bomFormat": "CycloneDX", "specVersion": "1.5", "components": [
        {"type": "operating-system", "name": "alpine", "version": "3.18"},
        {"type": "library", "name": "musl", "version": "1.2.3-r0",
         "purl": "pkg:apk/alpine/musl@1.2.3-r0?distro=alpine-3.18"}]}))
    spec = base / "spec.yaml"
    spec.write_text(USER_SPEC)
    jax_checks_for("dockerfile")  # the JAX registry loaded whole, once
    return {"tree": tree, "image": image, "bom": bom, "spec": spec, "db": build_db(base)}


TARGETS = {"fs": ("tree", ["--scanners", "vuln,misconfig,secret"]),
           "image": ("image", ["--scanners", "vuln,misconfig,secret"]),
           "sbom": ("bom", [])}


def run_both(env, wd, command, *extra, fmt="json"):
    """Both CLIs from ``wd``: (port output, JAX output, exit codes)."""
    key, head = TARGETS[command]
    outs, rcs = [], []
    for tag, main, dev in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, ["--backend", "cpu"])):
        out = wd / f"{tag}.{fmt}"
        out.unlink(missing_ok=True)
        rcs.append(main([command, *dev, *head, "--db-repository", env["db"], "--format", fmt,
                         "-o", str(out), "-q", "--cache-dir", str(wd / f"c-{tag}"), *extra,
                         str(env[key])]))
        outs.append(out.read_text() if out.exists() else None)
    return outs[0], outs[1], rcs[0], rcs[1]


@pytest.mark.parametrize("name", SPECS + ["@user"])
def test_specs_load_as_in_jax(env, name):
    ref = f"@{env['spec']}" if name == "@user" else name
    assert norm(compliance.load_spec(ref)) == norm(jax_compliance.load_spec(ref))
    assert sorted(compliance.BUILTIN_SPECS) == SPECS


@pytest.mark.parametrize("name", SPECS + ["@user"])
def test_apply_spec_equals_jax(env, name):
    """The statuses and findings of a spec over the same report, read by
    both packages from one JSON report of the tree."""
    src = env["tree"].parent / "report.json"
    if not src.exists():
        assert jax_cli.main(["fs", "--backend", "cpu", "--scanners", "vuln,misconfig,secret",
                             "--db-repository", env["db"], "--format", "json", "-q", "-o",
                             str(src), str(env["tree"])]) == 0
    doc = json.loads(src.read_text())
    ref = f"@{env['spec']}" if name == "@user" else name
    mine = compliance.apply_spec(compliance.load_spec(ref), types.Report.from_dict(doc))
    theirs = jax_compliance.apply_spec(jax_compliance.load_spec(ref),
                                       jax_types.Report.from_dict(doc))
    assert [(r.control.id, r.status, [f.to_dict() for f in r.findings]) for r in mine.results] \
        == [(r.control.id, r.status, [f.to_dict() for f in r.findings]) for r in theirs.results]
    assert mine.summary == theirs.summary


@pytest.mark.parametrize("fmt", ["json", "table"])
@pytest.mark.parametrize("name", SPECS + ["@user"])
def test_fs_compliance_equals_jax(env, wd, name, fmt):
    spec = f"@{env['spec']}" if name == "@user" else name
    mine, ref, rc1, rc2 = run_both(env, wd, "fs", "--compliance", spec, fmt=fmt)
    assert rc1 == rc2 == 0 and mine == ref
    if fmt == "json":
        doc = json.loads(mine)
        assert doc["ID"] == (name if name != "@user" else "acme-baseline")
        if name == "@user":
            statuses = {r["ID"]: r["Status"] for r in doc["Results"]}
            assert statuses == {"1": "FAIL", "2": "FAIL", "3": "FAIL", "4": "FAIL",
                                "5": "MANUAL", "6": "PASS"}


@pytest.mark.parametrize("command", ["image", "sbom"])
@pytest.mark.parametrize("name", ["docker-cis-1.6.0", "k8s-nsa-1.0", "@user"])
def test_image_and_sbom_compliance_equal_jax(env, wd, command, name):
    spec = f"@{env['spec']}" if name == "@user" else name
    for fmt in ("json", "table"):
        mine, ref, rc1, rc2 = run_both(env, wd, command, "--compliance", spec, fmt=fmt)
        assert rc1 == rc2 == 0 and mine == ref


@pytest.mark.parametrize("extra", [["--severity", "CRITICAL"], ["--ignorefile", "ignore"]],
                         ids=["severity", "ignorefile"])
def test_compliance_reads_the_filtered_report(env, wd, extra):
    (wd / "ignore").write_text("KSV017\nAVD-AWS-0088\n")
    mine, ref, rc1, rc2 = run_both(env, wd, "fs", "--compliance", f"@{env['spec']}", *extra)
    assert rc1 == rc2 == 0 and mine == ref
    statuses = {r["ID"]: r["Status"] for r in json.loads(mine)["Results"]}
    assert statuses["1"] == "PASS"


def test_exit_code_applies_when_a_control_fails(env, wd):
    mine, ref, rc1, rc2 = run_both(env, wd, "fs", "--compliance", f"@{env['spec']}",
                                   "--exit-code", "3")
    assert rc1 == rc2 == 3 and mine == ref
    mine, ref, rc1, rc2 = run_both(env, wd, "sbom", "--compliance", "docker-cis-1.6.0",
                                   "--exit-code", "3")
    assert rc1 == rc2 == 0 and mine == ref  # no DS* failure in an SBOM


@pytest.mark.parametrize("case", ["sarif", "unknown-spec", "missing-file"])
def test_refusals_exit_with_the_jax_codes(env, wd, case):
    spec, fmt = "docker-cis-1.6.0", "json"
    if case == "sarif":
        fmt = "sarif"
    elif case == "unknown-spec":
        spec = "cis-9.9"
    else:
        spec = f"@{wd / 'nope.yaml'}"
    mine, ref, rc1, rc2 = run_both(env, wd, "fs", "--compliance", spec, fmt=fmt)
    assert rc1 == rc2 == 2
    assert mine is None and ref is None


def test_a_spec_file_yaml_cannot_parse_exits_2_unlike_jax(env, wd, capsys):
    """A fault of the reference: ``@spec.yaml`` that YAML cannot parse ends
    the JAX CLI with the parser's traceback
    (``trivy_tpu/commands.py:382`` catches only ``ValueError`` and
    ``OSError``); the port exits 2 with a message, as for an unknown
    spec, and writes no report."""
    import yaml

    (wd / "bad.yaml").write_text("spec: [unclosed\n")
    spec = f"@{wd / 'bad.yaml'}"
    key, head = TARGETS["fs"]
    tail = [*head, "--format", "json", "-q", "--compliance", spec, str(env[key])]
    assert cli.main(["fs", "--device", "cpu", "-o", str(wd / "port.json"), *tail]) == 2
    assert "--compliance" in capsys.readouterr().err and not (wd / "port.json").exists()
    with pytest.raises(yaml.YAMLError):
        jax_cli.main(["fs", "--backend", "cpu", "-o", str(wd / "jax.json"), *tail])
