"""CloudFormation in the port (``trivy_tpu_torch/misconf/cloudformation``,
``misconf/adapters/aws_cfn.py`` and the scanner's route) against the JAX
package, on the CPU, with exact equality:

- the loaded resource blocks of the JAX tests' templates, of seeded stacks
  in YAML (short tags) and JSON (``Fn::`` forms), and of edge cases of
  every intrinsic (``Fn::Sub`` with pseudo parameters, ``Fn::If`` on a
  condition that cannot be resolved, ``!GetAtt`` forms, ``AWS::NoValue``,
  a condition cycle, broken documents), compared by class name and fields
  since each package has its own ``UNKNOWN`` and dataclasses;
- the adapter's AWS state of each, and the scanner's results per file;
- ``fs`` and ``image`` reports of a seeded tree of CloudFormation, Helm,
  Terraform, ARM, Dockerfiles and manifests in JSON, table and SARIF;
- ``--misconfig-scanners cloudformation,helm`` from the command line, the
  environment and the config file.
"""

from __future__ import annotations

import dataclasses
import json
import random

import pytest

from tests.iactree import CFN_IDS, HELM_IDS, cfn_json, cfn_yaml, write_iac_tree
from tests.imagetest import docker_save_tar, tar_bytes
from tests.secret_samples import SAMPLES
from tests.test_iac import CFN_YAML
from tests.test_torch_match import few_torch_threads  # noqa: F401
from tests.test_torch_misconf import _clean_custom_checks  # noqa: F401  (autouse)
from tests.test_torch_misconf_cli import (  # noqa: F401  (the wd fixture)
    assert_json_equal,
    failed_ids,
    run_both,
    wd,
)
from trivy_tpu.misconf import cloudformation as jax_cfn
from trivy_tpu.misconf.adapters import aws_cfn as jax_aws_cfn
from trivy_tpu.misconf.checks import checks_for as jax_checks_for
from trivy_tpu.misconf.scanner import MisconfScanner as JaxScanner
from trivy_tpu_torch.misconf import MisconfScanner, cloudformation
from trivy_tpu_torch.misconf.adapters import aws_cfn

SCANNERS = "misconfig,secret"
SECRETS = {"aws": SAMPLES["aws-access-key-id"], "github": SAMPLES["github-pat"]}

JSON_TEMPLATE = ('{"Resources": {"B": {"Type": "AWS::S3::Bucket",'
                 ' "Properties": {"BucketName": {"Fn::Join": ["-", ["a", "b"]]}}}}}')
# edge cases of the intrinsics and of the document's shape
EDGES = {
    "sub-pseudo.yaml": """Resources:
  B:
    Type: AWS::S3::Bucket
    Properties:
      BucketName: !Sub "${AWS::Region}-${AWS::Partition}-${AWS::URLSuffix}"
      Other: !Sub "${AWS::AccountId}-x"
      Literal: !Sub "${!NotAVar}-${Missing}"
      Open: !Sub "a-${unterminated"
      WithMap: !Sub ["${A}-${B.Arn}", {A: one}]
""",
    "if-unresolved.yaml": """Parameters:
  P:
    Type: String
Conditions:
  C: !Equals [!Ref P, x]
  Loop1: !Condition Loop2
  Loop2: !Condition Loop1
Resources:
  B:
    Type: AWS::S3::Bucket
    Condition: C
    Properties:
      A: !If [C, !Ref P, fallback]
      B: !If [C, known, !Ref P]
      C: !If [Loop1, yes, no]
      D: !If [Missing, 1, 2]
      E: !Not [!Condition C]
      F: !And [!Condition C, false]
      G: !Or [!Condition C, true]
""",
    "getatt.yaml": """Resources:
  A:
    Type: AWS::SNS::Topic
  B:
    Type: AWS::SQS::Queue
    Properties:
      X: !GetAtt A.TopicName
      Y: !GetAtt [A, Arn]
      Z: {"Fn::GetAtt": "A.Nested.Attr"}
      R: !Ref A
      S: !Ref Unknown
""",
    "novalue.yaml": """Resources:
  B:
    Type: AWS::EC2::SecurityGroup
    Properties:
      Tags:
        - !Ref AWS::NoValue
        - Key: k
          Value: v
      Drop: !Ref AWS::NoValue
      List: [a, !Ref "AWS::NoValue", b]
      Azs: !GetAZs ""
      Cidr: !Cidr [10.0.0.0/16, 4, 8]
      Imp: !ImportValue x
      Sel: !Select [9, [a, b]]
      Split: !Split [",", !Ref Unknown]
      Join: !Join [",", [a, !ImportValue y]]
      B64: !Base64 plain
      Map: !FindInMap [M, k1, k2]
""",
    "shapes.yaml": """Resources:
  NoType:
    Properties: {A: 1}
  Scalar: just-a-string
  WrongType:
    Type: [a, b]
  Ok:
    Type: AWS::SQS::Queue
    Properties:
      Empty: {}
      Nested: {A: {B: {C: [1, {D: 2}]}}}
""",
    "list.json": '{"Resources": [1, 2]}',
    "scalar.yaml": "just text\n",
    "empty.yaml": "",
    "bad.json": '{"Resources": {"B": {"Type": "AWS::S3::Bucket"}',
}


def norm(obj, _stack=()):
    """A package-free form of a loaded value: dataclasses by class name and
    fields, ``UNKNOWN`` as a marker, a ``CfnRef`` with its logical id and
    attribute, line-tracking maps and lists with their spans."""
    if id(obj) in _stack:
        return ("<cycle>", type(obj).__name__)
    stack = _stack + (id(obj),)
    name = type(obj).__name__
    if name == "UnknownType":
        return "<UNKNOWN>"
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (name, tuple((f.name, norm(getattr(obj, f.name), stack))
                            for f in dataclasses.fields(obj)))
    if isinstance(obj, dict):
        spans = (getattr(obj, "span", None), tuple(sorted(getattr(obj, "key_spans", {}).items(),
                                                          key=repr)))
        return (name, spans, tuple((norm(k, stack), norm(v, stack)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return (name, getattr(obj, "span", None), tuple(norm(x, stack) for x in obj))
    if isinstance(obj, str):
        return (name, str(obj), getattr(obj, "logical_id", None), getattr(obj, "attr", None))
    if obj is None or isinstance(obj, (bool, int, float, bytes)):
        return (name, obj)
    return (name, norm(vars(obj), stack)) if hasattr(obj, "__dict__") else (name, repr(obj))


def outcome(fn, *args):
    try:
        return ("ok", norm(fn(*args)))
    except Exception as e:  # the error is part of the contract
        return ("err", type(e).__name__, str(e))


def templates() -> dict[str, str]:
    """Every template of the comparisons: the JAX tests', the edge cases,
    and seeded stacks in both syntaxes."""
    out = {"test_iac.yaml": CFN_YAML, "test_iac.json": JSON_TEMPLATE, **EDGES}
    rng = random.Random(7)
    for i in range(6):
        out[f"seeded{i}.yaml"] = cfn_yaml(rng, i)
        out[f"seeded{i}.json"] = cfn_json(rng, i)
    return out


TEMPLATES = templates()


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_loaded_blocks_equal_jax(name):
    data = TEMPLATES[name].encode()
    mine = outcome(cloudformation.load, name, data)
    assert mine == outcome(jax_cfn.load, name, data)
    if name.startswith(("seeded", "test_iac")):
        assert mine[0] == "ok" and mine[1][2]  # blocks were loaded


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_adapter_state_equals_jax(name):
    data = TEMPLATES[name].encode()
    mine = outcome(lambda: aws_cfn.adapt(cloudformation.load(name, data)))
    assert mine == outcome(lambda: jax_aws_cfn.adapt(jax_cfn.load(name, data)))


def test_intrinsics_resolve_as_in_jax():
    """The values the JAX engine gives, spelled out: a ``Fn::Sub`` of the
    region, ``UNKNOWN`` for the account, the logical id and attribute of a
    ``!GetAtt``, and ``Fn::If`` over a condition that cannot be resolved:
    the true branch when it is known, else the false one."""
    def attrs(name):
        return {b.labels[0]: {k: v.value for k, v in b.attrs.items()}
                for b in cloudformation.load("e.yaml", EDGES[name].encode())}

    b = attrs("sub-pseudo.yaml")["B"]
    assert b["BucketName"] == "us-east-1-aws-amazonaws.com"
    assert type(b["Other"]).__name__ == "UnknownType"
    x = attrs("getatt.yaml")["B"]["Z"]
    assert (type(x).__name__, x.logical_id, x.attr) == ("CfnRef", "A", "Nested.Attr")
    b = attrs("if-unresolved.yaml")["B"]
    assert (b["A"], b["B"], type(b["E"]).__name__) == ("fallback", "known", "UnknownType")


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_scan_results_equal_jax(name):
    files = [(name, TEMPLATES[name].encode())]
    mine = [m.to_dict() for m in MisconfScanner().scan_files(files)]
    assert mine == [m.to_dict() for m in JaxScanner().scan_files(files)]


# -- the CLI on a seeded tree ---------------------------------------------------


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("cfn-cli")
    tree = base / "tree"
    write_iac_tree(tree, 3, secrets=dict(SECRETS))
    files = {str(p.relative_to(tree)): p.read_bytes() for p in tree.rglob("*") if p.is_file()}
    layer0 = tar_bytes({"etc/alpine-release": b"3.19.1\n"})
    layer1 = tar_bytes({f"src/{k}": v for k, v in files.items()})
    image = docker_save_tar(base / "img.tar", [layer0, layer1])
    jax_checks_for("dockerfile")  # the JAX registry loaded whole, once
    return {"base": base, "tree": tree, "image": image}


def types_of(doc: dict) -> set:
    return {r["Type"] for r in doc["Results"] if r["Class"] == "config"}


def test_fs_json_equals_jax(env, wd):
    mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", SCANNERS)
    assert rc1 == rc2 == 0
    doc = assert_json_equal(mine, ref)
    assert types_of(doc) == {"cloudformation", "helm", "terraform", "azure-arm", "dockerfile",
                             "kubernetes"}
    fails = set().union(*failed_ids(doc).values())
    assert CFN_IDS | HELM_IDS <= fails
    # the working directory's secret config enables the github-pat rule only
    assert {r["Target"] for r in doc["Results"] if r["Class"] == "secret"} == {
        "charts/svc0/values.yaml"}


@pytest.mark.parametrize("fmt", ["table", "sarif"])
def test_fs_table_and_sarif_bytes_equal_jax(env, wd, fmt):
    mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", SCANNERS, fmt=fmt)
    assert rc1 == rc2 == 0 and mine == ref
    assert "AVD-AWS-0088" in mine and "KSV017" in mine


@pytest.mark.parametrize("fmt", ["json", "table", "sarif"])
def test_image_equals_jax(env, wd, fmt):
    mine, ref, rc1, rc2 = run_both(wd, "image", env["image"], "--scanners", SCANNERS, fmt=fmt)
    assert rc1 == rc2 == 0
    if fmt != "json":
        assert mine == ref and "src/charts/svc0/templates/deployment.yaml" in mine
        return
    doc = assert_json_equal(mine, ref)
    assert {"cloudformation", "helm"} <= types_of(doc)
    assert any(t.startswith("src/cfn/") for t in failed_ids(doc))


@pytest.mark.parametrize("source", ["cli", "env", "config"])
def test_misconfig_scanners_cloudformation_and_helm_equal_jax(env, wd, monkeypatch, source):
    args = []
    if source == "cli":
        args = ["--misconfig-scanners", "cloudformation,helm"]
    elif source == "env":
        monkeypatch.setenv("TRIVY_TPU_MISCONFIG_SCANNERS", "cloudformation,helm")
    else:
        (wd / "trivy-tpu.yaml").write_text(
            "misconfiguration:\n  scanners: [cloudformation, helm]\n")
    mine, ref, rc1, rc2 = run_both(wd, "fs", env["tree"], "--scanners", "misconfig", *args)
    assert rc1 == rc2 == 0
    assert types_of(assert_json_equal(mine, ref)) == {"cloudformation", "helm"}


def test_a_stack_that_does_not_parse_is_no_result(env, wd, tmp_path):
    """A template YAML cannot parse: both packages drop it and scan on."""
    import shutil

    tree = tmp_path / "t"
    shutil.copytree(env["tree"], tree)
    (tree / "cfn" / "broken.yaml").write_text(
        "AWSTemplateFormatVersion: '2010-09-09'\nResources:\n  B: [unclosed\n")
    (tree / "cfn" / "broken.json").write_text('{"Resources": {"B": {"Type": ')
    mine, ref, rc1, rc2 = run_both(wd, "fs", tree, "--scanners", "misconfig")
    assert rc1 == rc2 == 0
    doc = assert_json_equal(mine, ref)
    assert not any(r["Target"].startswith("cfn/broken") for r in doc["Results"])
    assert json.loads(mine)["Results"]
