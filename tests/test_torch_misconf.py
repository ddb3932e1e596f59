"""The port's misconfiguration core against the JAX package, on the CPU:
detection of every type, the Dockerfile, YAML/JSON and Kubernetes parsers,
the DS* and KSV* check sets, custom Python and Rego checks, the scanner's
failure domain, the CloudFormation and Helm inputs that once stopped a
scan, the types' dict forms and the image history's Dockerfile. Inputs are the JAX tests'
fixtures and trees made from a numpy seed; every comparison is exact.

- The built-in check sets have the JAX ids and metadata.
- One check file loads into both packages and gives the same results.
- ``_load_builtins`` is safe under concurrent first use, where the JAX
  registry can be read half loaded (a fault of the reference).
- A custom check outlives the scan that loaded it, in both packages (a
  fault of the reference the port keeps).
- The new modules import neither ``jax`` nor ``trivy_tpu``.
"""

from __future__ import annotations

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_rego import K8S_CHECK, LEGACY_CHECK
from trivy_tpu import faults as jax_faults
from trivy_tpu import types as jax_types
from trivy_tpu.fanal.analyzers import imgconf as jax_imgconf
from trivy_tpu.misconf import custom as jax_custom
from trivy_tpu.misconf import detection as jax_detection
from trivy_tpu.misconf.checks import checks_for as jax_checks_for
from trivy_tpu.misconf.checks import unregister as jax_unregister
from trivy_tpu.misconf.parse import dockerfile as jax_dockerfile
from trivy_tpu.misconf.parse import kubernetes as jax_kubernetes
from trivy_tpu.misconf.parse import yamljson as jax_yamljson
from trivy_tpu.misconf.scanner import MisconfScanner as JaxScanner
from trivy_tpu.misconf.scanner import ScannerOption as JaxOption
from trivy_tpu_torch import faults, obs, types
from trivy_tpu_torch.fanal.analyzers import imgconf
from trivy_tpu_torch.fanal.config import MAX_CONFIG_BYTES, ConfigAnalyzer
from trivy_tpu_torch.misconf import (
    MisconfScanner,
    ScannerOption,
    custom,
    detection,
)
from trivy_tpu_torch.misconf.checks import checks_for, unregister
from trivy_tpu_torch.misconf.parse import dockerfile, kubernetes, yamljson

REPO = Path(__file__).resolve().parent.parent

# the JAX tests' fixtures (tests/test_misconf.py, tests/test_faults.py)
DOCKERFILES = {
    "Dockerfile": b"""FROM alpine:latest
MAINTAINER a@b.c
RUN apk add curl
RUN apt-get update
RUN apt-get install foo
EXPOSE 22 70000
ADD src /app
WORKDIR app
USER root
CMD ["a"]
CMD ["b"]
""",
    "clean/Dockerfile": b"""FROM alpine:3.19
RUN apk add --no-cache curl
HEALTHCHECK CMD curl -f http://localhost/ || exit 1
USER app
COPY src /app
WORKDIR /app
ENTRYPOINT ["/app/run"]
""",
    "multi/Dockerfile.prod": b"""# build
FROM golang:1.22 AS build
RUN go build \\
    -o /bin/app \\
    ./cmd
FROM alpine:3.19
COPY --from=build /bin/app /bin/app
ENTRYPOINT ["/bin/app"]
""",
    "a/Dockerfile": b"FROM alpine:3.18\nUSER root\nADD . /app\n",
    "x.dockerfile": b"FROM scratch\n# only a comment\n\nRUN [\"/bin/true\"]\n",
    "Containerfile": b"FROM alpine:latest\nUSER app\n",
}
MANIFESTS = {
    "d.yaml": b"""apiVersion: apps/v1
kind: Deployment
metadata:
  name: web
spec:
  template:
    spec:
      hostPID: true
      containers:
      - name: app
        image: nginx:latest
""",
    "c.yaml": b"""apiVersion: batch/v1
kind: CronJob
metadata:
  name: c
spec:
  jobTemplate:
    spec:
      template:
        spec:
          containers:
          - name: job
            image: busybox:1.36
            securityContext:
              privileged: true
""",
    "p.yaml": b"""apiVersion: v1
kind: Pod
metadata:
  name: good
  annotations:
    container.apparmor.security.beta.kubernetes.io/app: runtime/default
spec:
  automountServiceAccountToken: false
  containers:
  - name: app
    image: nginx:1.25.3
    securityContext:
      allowPrivilegeEscalation: false
      runAsNonRoot: true
      runAsUser: 10001
      runAsGroup: 10001
      readOnlyRootFilesystem: true
      seccompProfile:
        type: RuntimeDefault
      capabilities:
        drop: [ALL]
    resources:
      limits: {cpu: "1", memory: 1Gi}
      requests: {cpu: 500m, memory: 512Mi}
""",
    "s.yaml": b"""apiVersion: v1
kind: Service
metadata:
  name: s
spec:
  ports: [{port: 80}]
""",
    "multi.yaml": b"""apiVersion: v1
kind: Pod
metadata:
  name: a
spec:
  hostNetwork: true
  containers:
  - name: c1
    image: img:1.0
---
apiVersion: v1
kind: Pod
metadata:
  name: b
spec:
  hostNetwork: true
  containers:
  - name: c2
    image: img:1.0
""",
    "pod.json": b'{"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "j"},'
                b' "spec": {"containers": [{"name": "c", "image": "x"}]}}',
}
# one input of each type detection tells apart, and the edge cases
DETECT = [
    ("Dockerfile", b"FROM x"), ("app/Dockerfile.prod", b"FROM x"), ("prod.dockerfile", b""),
    ("Containerfile", b""), ("Dockerfile.txt", b""), ("README.md", b""),
    ("pod.yaml", b"apiVersion: v1\nkind: Pod\nmetadata:\n  name: x\n"),
    ("values.yaml", b"replicas: 3\n"), ("cfg.json", b'{"a": 1}'),
    ("stack.yaml", b"AWSTemplateFormatVersion: '2010-09-09'\nResources:\n  B:\n"
                   b"    Type: AWS::S3::Bucket\n"),
    ("stack.json", b'{"Resources": {"B": {"Type": "AWS::S3::Bucket"}}}'),
    ("tags.yaml", b"Resources:\n  B:\n    Type: AWS::SNS::Topic\n    Name: !Ref X\n"),
    ("main.tf", b""), ("vars.tfvars", b"a = 1\n"), ("main.tf.json", b"{}"),
    ("plan.json", b'{"format_version": "1.2", "planned_values": {}}'),
    ("arm.json", b'{"$schema": "https://schema.management.azure.com/schemas/x#"}'),
    ("chart/Chart.yaml", b"apiVersion: v2\nname: c\n"),
    ("chart/templates/dep.yaml", b"kind: Deployment\nname: {{ .Values.n }}\n"),
    ("chart/templates/plain.yaml", b"a: 1\n"), ("chart/values.schema.json", b"{}"),
    ("x.yaml", b"Resources: [a, b]\n"), ("x.json", b'{"Resources": [1, 2]}'),
    ("bad.yaml", b"a: [1,\n"), ("bad.json", b"{"), ("list.yaml", b"- 1\n- 2\n"),
    ("mixed.yaml", b"apiVersion: v1\nkind: Pod\nmetadata: {}\n---\n- 1\n"),
    ("empty.yaml", b""), ("notes.txt", b"hello"), ("k.yml", b"kind: Pod\n"),
    ("helm/templates/_h.tpl", b"{{ define \"x\" }}{{ end }}"),
]
PY_CHECK = """
@check(id="USR-PY-001", severity="high", types=("yaml", "json"), title="debug enabled")
def debug_enabled(docs):
    for doc in docs:
        if isinstance(doc, dict) and doc.get("debug") is True:
            yield Failure("debug is enabled", start_line=doc.line("debug"))


@check(id="USR-PY-002", severity="LOW", types=("dockerfile",), title="no latest base")
def latest(df):
    for st in df.stages:
        if st.base.endswith(":latest"):
            yield Failure(f"stage {st.name or st.base} uses latest", start_line=st.start_line)


@cloud_check(id="USR-CLOUD-1", severity="LOW", title="registers only", targets="buckets")
def cloud(state):
    return []
"""


def drop_custom_checks():
    """Take every custom check out of both registries."""
    for mod, unreg in ((custom, unregister), (jax_custom, jax_unregister)):
        for cid in list(mod._custom_ids):
            unreg(cid)
        mod._custom_ids.clear()
        mod._loaded_files.clear()


@pytest.fixture(autouse=True)
def _clean_custom_checks():
    """Run each test with the registries a fresh process has: before it, as
    well as after. Custom checks stay registered process-wide in both
    packages, and a test of another file in the same worker (the JAX
    ``tests/test_iac.py::TestCustomChecks``) leaves its checks behind."""
    drop_custom_checks()
    yield
    drop_custom_checks()


def seeded_dockerfile(rng: np.random.Generator) -> bytes:
    """A Dockerfile of random instructions: stages, flags, JSON and shell
    forms, continuations and interleaved comments."""
    bases = ["alpine:latest", "alpine:3.19", "ubuntu", "golang:1.22", "scratch", "node:20"]
    body = [f"FROM {bases[rng.integers(len(bases))]}" + (" AS b0" if rng.random() < 0.5 else "")]
    pool = [
        "RUN apt-get update", "RUN apt-get install -y curl", "RUN apk add curl",
        "RUN apk add --no-cache git", "RUN sudo make install", "RUN cd /x && make",
        "RUN yum install -y httpd", "RUN pip install flask", "RUN curl http://x | sh",
        "RUN wget http://x/y", "USER root", "USER 1000", "USER app", "WORKDIR app",
        "WORKDIR /srv", "EXPOSE 22", "EXPOSE 8080 70000", "ADD src /app", "ADD x.tar /x",
        "COPY --from=b0 /a /a", "COPY --chown=1:1 a b", "COPY a b c", "MAINTAINER me",
        'CMD ["a"]', "CMD b", 'ENTRYPOINT ["/app"]', "HEALTHCHECK CMD true",
        "HEALTHCHECK NONE", "ENV A=1", "ARG V", "LABEL a=b", "SHELL [\"/bin/bash\", \"-c\"]",
        "ONBUILD RUN x", "STOPSIGNAL SIGTERM", "VOLUME /data", "FROM alpine:3.18 AS b1",
        "RUN zypper install x", "RUN dnf install -y x", "RUN apt-get -y upgrade",
    ]
    for _ in range(int(rng.integers(3, 14))):
        line = pool[rng.integers(len(pool))]
        if line.startswith("RUN") and rng.random() < 0.3:
            line = line + " && \\\n    echo done \\\n    # a comment\n    && true"
        if rng.random() < 0.1:
            body.append("# comment")
        body.append(line)
    return ("\n".join(body) + "\n").encode()


def seeded_manifest(rng: np.random.Generator) -> bytes:
    """A multi-document manifest of random workload kinds and security
    settings."""
    docs = []
    for d in range(int(rng.integers(1, 4))):
        kind = ["Pod", "Deployment", "StatefulSet", "DaemonSet", "Job", "CronJob",
                "ReplicaSet", "Service", "ConfigMap"][rng.integers(9)]
        sc = []
        for key, vals in (("privileged", ["true", "false"]), ("runAsNonRoot", ["true", "false"]),
                          ("readOnlyRootFilesystem", ["true", "false"]),
                          ("allowPrivilegeEscalation", ["true", "false"]),
                          ("runAsUser", ["0", "1000", "10001"])):
            if rng.random() < 0.5:
                sc.append(f"{key}: {vals[rng.integers(len(vals))]}")
        if rng.random() < 0.3:
            sc.append("capabilities:\n  add: [SYS_ADMIN]\n  drop: [ALL]")
        image = ["nginx:latest", "nginx:1.25", "busybox", "x@sha256:" + "a" * 64][rng.integers(4)]
        container = [f"- name: c{d}", f"  image: {image}"]
        if sc:
            container.append("  securityContext:")
            container += ["    " + ln for s in sc for ln in s.split("\n")]
        if rng.random() < 0.5:
            container += ["  resources:", "    limits: {cpu: '1', memory: 1Gi}"]
        spec = [f"hostNetwork: {str(bool(rng.random() < 0.3)).lower()}", "containers:",
                *container]
        if rng.random() < 0.3:
            spec += ["volumes:", "- name: v", "  hostPath: {path: /var/run/docker.sock}"]
        if kind == "Pod":
            body = spec
        elif kind == "CronJob":
            body = ["jobTemplate:", "  spec:", "    template:", "      spec:",
                    *("        " + s for s in spec)]
        elif kind in ("Service", "ConfigMap"):
            body = ["ports: [{port: 80}]"]
        else:
            body = ["template:", "  spec:", *("    " + s for s in spec)]
        docs.append("\n".join([f"apiVersion: v1\nkind: {kind}\nmetadata:\n  name: w{d}",
                               "spec:", *("  " + b for b in body)]) + "\n")
    return "---\n".join(docs).encode()


def seeded_files(seed: int, n: int = 12) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        out[f"svc{i}/Dockerfile"] = seeded_dockerfile(rng)
        out[f"k8s/m{i}.yaml"] = seeded_manifest(rng)
    return out


# -- detection ---------------------------------------------------------------


@pytest.mark.parametrize("path,content", DETECT, ids=[p for p, _ in DETECT])
def test_detect_type_equals_jax(path, content):
    assert detection.detect_type(path, content) == jax_detection.detect_type(path, content)
    assert detection.relevant(path) == jax_detection.relevant(path)


def test_every_type_is_detected():
    got = {detection.detect_type(p, c) for p, c in DETECT}
    assert got == {None, *(getattr(detection, n) for n in dir(detection)
                           if n.startswith("FILE_TYPE_"))}


def test_detect_type_on_seeded_files_equals_jax():
    for path, content in seeded_files(3).items():
        assert detection.detect_type(path, content) == jax_detection.detect_type(path, content)


# -- parsers -----------------------------------------------------------------


def spans(obj):
    """A loaded document with its line spans, as plain data."""
    if isinstance(obj, (yamljson.LMap, jax_yamljson.LMap)):
        return ("map", obj.span, sorted(obj.key_spans.items(), key=repr),
                [(k, spans(v)) for k, v in obj.items()])
    if isinstance(obj, (yamljson.LSeq, jax_yamljson.LSeq)):
        return ("seq", obj.span, [spans(v) for v in obj])
    return obj


@pytest.mark.parametrize("name", sorted(DOCKERFILES))
def test_dockerfile_parse_equals_jax(name):
    a, b = dockerfile.parse(DOCKERFILES[name]), jax_dockerfile.parse(DOCKERFILES[name])
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [i.args for i in a.instructions] == [i.args for i in b.instructions]


def test_seeded_dockerfiles_parse_equals_jax():
    rng = np.random.default_rng(11)
    for _ in range(40):
        content = seeded_dockerfile(rng)
        assert (dataclasses.asdict(dockerfile.parse(content))
                == dataclasses.asdict(jax_dockerfile.parse(content)))


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_yaml_and_kubernetes_parse_equal_jax(name):
    content = MANIFESTS[name]
    assert ([spans(d) for d in yamljson.load_all(content)]
            == [spans(d) for d in jax_yamljson.load_all(content)])
    a, b = kubernetes.parse(content), jax_kubernetes.parse(content)
    assert ([(w.kind, w.name, w.span, spans(w.raw), [(c.name, c.kind, c.span) for c in
                                                    w.containers]) for w in a]
            == [(w.kind, w.name, w.span, spans(w.raw), [(c.name, c.kind, c.span) for c in
                                                       w.containers]) for w in b])


def test_yaml_line_spans():
    docs = yamljson.load_all(b"a: 1\nb:\n  c: 2\n---\nx: 9\n")
    assert [d.line("a") for d in docs[:1]] == [1] and docs[0]["b"].line("c") == 3
    assert docs[1].line("x") == 5
    with pytest.raises(Exception):
        yamljson.load_all(b"a: [1,\n")


# -- checks ------------------------------------------------------------------


def check_meta(c):
    return (c.id, c.avd_id, c.title, c.severity, c.file_types, c.description, c.resolution,
            c.url, c.service, c.provider, c.targets, c.namespace, c.fn.__name__)


@pytest.mark.parametrize("ftype", ["dockerfile", "kubernetes", "yaml", "json"])
def test_builtin_check_sets_equal_jax(ftype):
    mine, ref = checks_for(ftype), jax_checks_for(ftype)
    assert [check_meta(c) for c in mine] == [check_meta(c) for c in ref]
    if ftype in ("dockerfile", "kubernetes"):
        assert len(mine) > 20


@pytest.mark.parametrize("name", sorted(DOCKERFILES) + sorted(MANIFESTS))
def test_scan_file_equals_jax(name):
    content = {**DOCKERFILES, **MANIFESTS}[name]
    mine = MisconfScanner().scan_file(name, content)
    ref = JaxScanner().scan_file(name, content)
    assert mine is not None and mine.to_dict() == ref.to_dict()


def test_seeded_scan_files_equal_jax():
    files = sorted(seeded_files(7, n=20).items())
    mine = [m.to_dict() for m in MisconfScanner().scan_files(files)]
    ref = [m.to_dict() for m in JaxScanner().scan_files(files)]
    assert mine == ref and len(mine) == 40
    fails = {f["ID"] for m in mine for f in m["Failures"]}
    assert any(i.startswith("DS") for i in fails) and any(i.startswith("KSV") for i in fails)


def test_disabled_ids_and_file_types_equal_jax():
    files = sorted({**DOCKERFILES, **MANIFESTS}.items())
    for opt in ({"check_ids_disabled": ["DS001", "AVD-KSV-0017", "KSV009"]},
                {"file_types": ["kubernetes"]}, {"file_types": ["dockerfile", "json"]}):
        mine = [m.to_dict() for m in MisconfScanner(ScannerOption(**opt)).scan_files(files)]
        ref = [m.to_dict() for m in JaxScanner(JaxOption(**opt)).scan_files(files)]
        assert mine == ref, opt


def test_one_crashing_file_does_not_kill_the_batch():
    files = [("a/Dockerfile", DOCKERFILES["a/Dockerfile"]),
             ("b/Dockerfile", DOCKERFILES["a/Dockerfile"])]
    spec = "misconf.eval@a/Dockerfile:times=-1"
    try:
        faults.configure(spec)
        jax_faults.configure(spec)
        with obs.scan_context(name="t") as ctx:
            mine = MisconfScanner().scan_files(files)
            health = ctx.health_snapshot()
        ref = JaxScanner().scan_files(files)
    finally:
        faults.clear()
        jax_faults.clear()
    assert [m.to_dict() for m in mine] == [m.to_dict() for m in ref]
    assert [m.file_path for m in mine] == ["b/Dockerfile"]
    assert health.get("misconf.skipped") == 1


# -- CloudFormation and Helm inputs that once stopped a scan ------------------


@pytest.mark.parametrize("path,content,ftype", [
    ("stack.yaml", DETECT[9][1], "cloudformation"),
    ("stack.json", DETECT[10][1], "cloudformation"),
    ("tags.yaml", DETECT[11][1], "cloudformation"),
    ("chart/Chart.yaml", b"apiVersion: v2\nname: c\n", "helm"),
    ("chart/templates/dep.yaml", DETECT[18][1], "helm"),
])
def test_cloudformation_and_helm_inputs_scan_as_in_jax(path, content, ftype):
    """The inputs that stopped a scan before CloudFormation and Helm were
    ported: beside a Dockerfile, with every type, with the type named and
    with it left out, the port's results equal the JAX package's."""
    files = [("Dockerfile", DOCKERFILES["Dockerfile"]), (path, content)]
    assert detection.detect_type(path, content) == ftype
    for types in ([], ["dockerfile", ftype], [ftype], ["dockerfile"]):
        mine = MisconfScanner(ScannerOption(file_types=types)).scan_files(files)
        ref = JaxScanner(JaxOption(file_types=types)).scan_files(files)
        assert [m.to_dict() for m in mine] == [m.to_dict() for m in ref], types
        assert [m.file_type for m in mine] == [m.file_type for m in ref]
        if not types or types == ["dockerfile"]:
            assert "Dockerfile" in {m.file_path for m in mine}


# -- custom checks -----------------------------------------------------------


def test_a_custom_check_outlives_its_scan_in_both_packages(tmp_path):
    """A fault of the reference that the port keeps: ``--config-check``
    registers its checks process-wide (``trivy_tpu/misconf/custom.py``
    ``load_custom_checks``), so a later scan in the same process without
    check paths still runs them. A JAX test that loads a check
    (``tests/test_iac.py::TestCustomChecks``) so changed the first port
    test of a file after it in one worker; the autouse fixture now gives
    every test a fresh process's registries."""
    (tmp_path / "c.py").write_text(PY_CHECK)
    files = [("values.yaml", b"replicas: 2\ndebug: true\n")]
    for scanner, option in ((MisconfScanner, ScannerOption), (JaxScanner, JaxOption)):
        assert not scanner(option()).scan_files(files)
        scanner(option(check_paths=[str(tmp_path / "c.py")])).scan_files(files)
        later = scanner(option()).scan_files(files)
        assert {f.id for m in later for f in m.failures} == {"USR-PY-001"}
    mine = [m.to_dict() for m in MisconfScanner().scan_files(files)]
    assert mine == [m.to_dict() for m in JaxScanner().scan_files(files)]


def test_one_check_file_loads_into_both_packages(tmp_path):
    (tmp_path / "checks").mkdir()
    (tmp_path / "checks" / "user.py").write_text(PY_CHECK)
    (tmp_path / "checks" / "k8s.rego").write_text(K8S_CHECK)
    (tmp_path / "checks" / "df.rego").write_text(LEGACY_CHECK)
    (tmp_path / "checks" / "df_test.rego").write_text("package ignored\n")
    paths = [str(tmp_path / "checks")]
    assert custom.load_custom_checks(paths) == jax_custom.load_custom_checks(paths) == 5
    files = sorted({**DOCKERFILES, **MANIFESTS, "values.yaml": b"replicas: 2\ndebug: true\n",
                    "cfg.json": b'{\n  "debug": true\n}\n',
                    "curl/Dockerfile": b"FROM alpine:3.18\nRUN curl http://x | sh\n"}.items())
    mine = [m.to_dict() for m in MisconfScanner().scan_files(files)]
    ref = [m.to_dict() for m in JaxScanner().scan_files(files)]
    assert mine == ref
    ids = {f["ID"] for m in mine for f in m["Failures"]}
    assert {"USR-PY-001", "USR-PY-002", "USR-K8S-100", "USR-DF-200"} <= ids
    # reloading an unchanged file registers nothing new
    assert custom.load_custom_checks(paths) == 0


def test_the_scanner_option_loads_check_paths(tmp_path):
    p = tmp_path / "user.py"
    p.write_text(PY_CHECK)
    files = [("values.yaml", b"debug: true\n")]
    mine = MisconfScanner(ScannerOption(check_paths=[str(p)])).scan_files(files)
    ref = JaxScanner(JaxOption(check_paths=[str(p)])).scan_files(files)
    assert [m.to_dict() for m in mine] == [m.to_dict() for m in ref]
    assert [f.id for f in mine[0].failures] == ["USR-PY-001"]


@pytest.mark.parametrize("source,match", [
    ("def broken(:\n", "failed to load"),
    ("@check(id='DS001', severity='LOW', title='x', types=('dockerfile',))\n"
     "def f(df):\n    return []\n", "registered twice"),
])
def test_bad_check_files_fail_as_in_jax(tmp_path, source, match):
    p = tmp_path / "bad.py"
    p.write_text(source)
    for mod in (custom, jax_custom):
        with pytest.raises(mod.CustomCheckError, match=match):
            mod.load_custom_checks([str(p)])


def test_rego_check_errors_as_in_jax(tmp_path):
    p = tmp_path / "bad.rego"
    p.write_text("package user.x\ndeny[m] { every v in input.xs { v } ; m := \"x\" }\n")
    for mod in (custom, jax_custom):
        with pytest.raises(mod.CustomCheckError, match="every"):
            mod.load_custom_checks([str(p)])
    with pytest.raises(custom.CustomCheckError, match="neither"):
        custom.load_custom_checks([str(tmp_path / "x.txt")])


# -- the analyzer, the types and the image history ---------------------------


def test_config_analyzer_requires_what_jax_requires():
    from trivy_tpu.fanal.analyzers.config import MAX_CONFIG_BYTES as JAX_MAX

    assert MAX_CONFIG_BYTES == JAX_MAX
    a = ConfigAnalyzer()
    for path, _c in DETECT:
        for size in (0, MAX_CONFIG_BYTES, MAX_CONFIG_BYTES + 1):
            assert a.required(path, size) == (size <= JAX_MAX and jax_detection.relevant(path))


def test_types_round_trip_equal_jax():
    mc = JaxScanner().scan_file("d.yaml", MANIFESTS["d.yaml"])
    d = mc.to_dict()
    assert types.Misconfiguration.from_dict(d).to_dict() == d
    r = jax_types.Result(target="d.yaml", cls="config", type="kubernetes",
                         misconfigurations=mc.successes + mc.failures)
    assert types.Result.from_dict(r.to_dict()).to_dict() == r.to_dict()
    blob = jax_types.BlobInfo(misconfigurations=[mc])
    assert types.BlobInfo.from_dict(blob.to_dict()).to_wire_dict() == blob.to_dict()
    assert not types.Result(target="x", misconfigurations=[types.MisconfResult(id="a")]).is_empty


HISTORIES = [
    [{"created_by": "/bin/sh -c #(nop) ADD file:abc in / "},
     {"created_by": "/bin/sh -c #(nop)  CMD [\"sh\"]", "empty_layer": True},
     {"created_by": "/bin/sh -c apk add curl"}, {"created_by": "USER root"}],
    [{"created_by": "RUN /bin/sh -c apt-get update # buildkit"},
     {"created_by": "COPY . /app # buildkit"}, {"created_by": ""}, {},
     {"created_by": "make install"}, {"created_by": "/bin/sh -c #(nop)HEALTHCHECK NONE"}],
    [],
]


@pytest.mark.parametrize("i", range(len(HISTORIES)))
def test_image_history_equals_jax(i):
    config = {"history": HISTORIES[i], "config": {"Env": ["PATH=/usr/bin"]}}
    assert imgconf.history_to_dockerfile(config) == jax_imgconf.history_to_dockerfile(config)

    class Opt:  # the JAX ArtifactOption fields analyze_image_config reads
        disabled_analyzers = ["secret", "apk-command"]
        secret_config_path = None

    mine = imgconf.analyze_image_config(config, secret=False, misconfig=True)
    ref = jax_imgconf.analyze_image_config(config, Opt())
    assert ([m.to_dict() for m in mine.misconfigurations]
            == [m.to_dict() for m in ref.misconfigurations])
    assert bool(mine.misconfigurations) == bool(HISTORIES[i])
    assert imgconf.analyze_image_config(config, secret=False).misconfigurations == []


# -- the registry's first use ------------------------------------------------


def test_builtins_load_safely_from_two_threads():
    """Two threads asking for the check sets of a fresh process both get
    them whole. The JAX ``_load_builtins`` sets its flag before importing,
    so there the second thread can read a registry without the Kubernetes
    checks, and an image's layers analyzed at once lose their manifests'
    results."""
    code = ("import threading\n"
            "from trivy_tpu_torch.misconf.checks import checks_for\n"
            "out = {}\n"
            "def f(t): out[t] = len(checks_for(t))\n"
            "ts = [threading.Thread(target=f, args=(t,)) for t in ('dockerfile', 'kubernetes')]\n"
            "[t.start() for t in ts]; [t.join() for t in ts]\n"
            "print(out['dockerfile'], out['kubernetes'])\n")
    for _ in range(3):
        p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                           text=True, timeout=120, check=True)
        assert p.stdout.split() == [str(len(jax_checks_for("dockerfile"))),
                                    str(len(jax_checks_for("kubernetes")))]


NEW_MODULES = ("trivy_tpu_torch.misconf", "trivy_tpu_torch.misconf.scanner",
               "trivy_tpu_torch.misconf.detection", "trivy_tpu_torch.misconf.custom",
               "trivy_tpu_torch.misconf.checks", "trivy_tpu_torch.misconf.checks.docker",
               "trivy_tpu_torch.misconf.checks.kubernetes",
               "trivy_tpu_torch.misconf.parse.dockerfile",
               "trivy_tpu_torch.misconf.parse.kubernetes",
               "trivy_tpu_torch.misconf.parse.yamljson", "trivy_tpu_torch.fanal.config",
               "trivy_tpu_torch.plugin", "trivy_tpu_torch.log", "trivy_tpu_torch.cli",
               "trivy_tpu_torch.misconf.state", "trivy_tpu_torch.misconf.hcl",
               "trivy_tpu_torch.misconf.hcl.lexer", "trivy_tpu_torch.misconf.hcl.parser",
               "trivy_tpu_torch.misconf.hcl.functions", "trivy_tpu_torch.misconf.hcl.evaluator",
               "trivy_tpu_torch.misconf.terraform", "trivy_tpu_torch.misconf.tfplan",
               "trivy_tpu_torch.misconf.arm", "trivy_tpu_torch.misconf.adapters",
               "trivy_tpu_torch.misconf.adapters.aws_state",
               "trivy_tpu_torch.misconf.adapters.aws_tf",
               "trivy_tpu_torch.misconf.adapters.google_state",
               "trivy_tpu_torch.misconf.adapters.google_tf",
               "trivy_tpu_torch.misconf.adapters.azure_tf",
               "trivy_tpu_torch.misconf.adapters.github_state",
               "trivy_tpu_torch.misconf.adapters.extra_providers",
               "trivy_tpu_torch.misconf.checks.cloud_aws",
               "trivy_tpu_torch.misconf.checks.cloud_google",
               "trivy_tpu_torch.misconf.checks.cloud_azure",
               "trivy_tpu_torch.misconf.checks.cloud_github",
               "trivy_tpu_torch.misconf.checks.cloud_extra",
               "trivy_tpu_torch.misconf.cloudformation",
               "trivy_tpu_torch.misconf.adapters.aws_cfn", "trivy_tpu_torch.misconf.helm",
               "trivy_tpu_torch.compliance", "trivy_tpu_torch.k8s",
               "trivy_tpu_torch.k8s_node")


def test_new_modules_import_neither_jax_nor_the_jax_package():
    for mod in NEW_MODULES:
        path = REPO / mod.replace(".", "/")
        path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "trivy_tpu"), (mod, name)
    code = ("import sys; import " + ", ".join(NEW_MODULES)
            + "; from trivy_tpu_torch.misconf.checks import all_checks; all_checks()"
            + "; bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'trivy_tpu')]"
            + "; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
