"""Helm in the port (``trivy_tpu_torch/misconf/helm``, the scanner's chart
lane) against the JAX package, on the CPU, with exact equality:

- the tokens and parse trees of templates, and the rendered text of
  snippets that reach every function of the table and every action
  (``if``/``else if``, ``range`` over lists and maps, ``with``,
  ``define``, ``template``, ``include``, ``tpl``, variables, pipelines,
  trimming, errors), and of ``_go_printf``;
- each template's rendered text of the JAX tests' chart and of seeded
  charts, byte for byte (the Kubernetes checks give line numbers from it);
- the chart lane's ownership rule: a chart's YAML, JSON and manifests feed
  the render, a Dockerfile inside a chart keeps its own pass; a chart the
  renderer cannot parse is skipped, not raised;
- an incremental rescan of a tree with a chart;
- ``--fleet --scanners misconfig,secret`` in both mixes of coordinator and
  replica, with sync and async shards, and a ``misconfig`` shard sent to
  a port and a JAX server.
"""

from __future__ import annotations

import json
import random
import shutil
import tempfile
from pathlib import Path

import pytest

from tests.iactree import HELM_IDS, write_chart, write_iac_tree
from tests.secret_samples import SAMPLES
from tests.test_helm_corpus import _chart_files
from tests.test_torch_cloudformation import norm
from tests.test_torch_fleet_replica import clean_breaker_gauges, post  # noqa: F401
from tests.test_torch_match import few_torch_threads  # noqa: F401
from tests.test_torch_misconf import _clean_custom_checks  # noqa: F401  (autouse)
from tests.test_torch_misconf_cli import (  # noqa: F401  (the wd fixture)
    assert_json_equal,
    failed_ids,
    run_both,
    wd,
)
from trivy_tpu import cli as jax_cli
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu.misconf import helm as jax_helm
from trivy_tpu.misconf.checks import checks_for as jax_checks_for
from trivy_tpu.misconf.scanner import MisconfScanner as JaxScanner
from trivy_tpu.rpc.admission import resolve_admission as jax_resolve_admission
from trivy_tpu.rpc.server import start_server as jax_start_server
from trivy_tpu_torch import cli, rpc
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.misconf import MisconfScanner, helm
from trivy_tpu_torch.rpc.admission import resolve_admission
from trivy_tpu_torch.rpc.server import start_server

VALUES = {"name": "web", "n": 3, "on": True, "off": False, "empty": "", "none": None,
          "list": ["b", "a", "c"], "map": {"z": 1, "a": "x", "m": [1, 2]},
          "nested": {"deep": {"key": "v"}}, "text": "  Hello World  ", "num": "42",
          "tplsrc": "name={{ .Values.name }}", "labels": 'env: "prod"',
          "yaml": "a: 1\nb: [x, y]\n"}
META = {"name": "demo", "version": "1.2.3", "appVersion": "9.9"}
DEFINES = {"_h.tpl": '{{- define "demo.name" -}}{{ .Chart.Name }}-{{ .Values.name }}{{- end }}'
                     '{{ define "demo.arg" }}[{{ . }}]{{ end }}'
                     '{{- define "demo.nested" -}}{{ include "demo.name" . | upper }}{{- end }}'}
# one snippet per action and function of the renderer, and error cases
SNIPPETS = [
    "plain text, no actions\n",
    "{{ .Values.name }} {{ .Chart.Name }} {{ .Chart.Version }} {{ .Release.Name }}",
    "{{ .Release.Namespace }} {{ .Capabilities.KubeVersion.Version }} {{ .Template.BasePath }}",
    "{{ .Values.nested.deep.key }} {{ .Values.missing.key }} {{ $.Values.name }}",
    "a  {{- .Values.name -}}  b\n  {{- .Values.n }}\n{{ .Values.n -}}\n  c",
    "{{/* a comment */}}x{{- /* trimmed */ -}} y",
    "{{ if .Values.on }}on{{ end }}|{{ if .Values.off }}x{{ else }}off{{ end }}",
    "{{ if .Values.off }}1{{ else if .Values.empty }}2{{ else if .Values.n }}3{{ end }}",
    "{{ if and .Values.on .Values.n }}a{{ end }}{{ if or .Values.off .Values.empty }}b{{ end }}",
    "{{ if not .Values.off }}not{{ end }}{{ if empty .Values.list }}e{{ end }}",
    "{{ range .Values.list }}[{{ . }}]{{ end }}",
    "{{ range $i, $v := .Values.list }}{{ $i }}={{ $v }};{{ end }}",
    "{{ range $k, $v := .Values.map }}{{ $k }}:{{ $v }} {{ end }}",
    "{{ range .Values.map }}<{{ . }}>{{ end }}",
    "{{ range .Values.none }}x{{ else }}none{{ end }}",
    "{{ with .Values.nested.deep }}{{ .key }}{{ end }}|{{ with .Values.off }}x{{ else }}w{{ end }}",
    "{{ $x := .Values.name }}{{ $x }}{{ $x = \"re\" }}{{ $x }}",
    '{{ include "demo.name" . }} {{ template "demo.arg" .Values.n }}',
    '{{ include "demo.nested" . }} {{ include "nope" . }}',
    '{{ define "local" }}L{{ end }}{{ include "local" . }}',
    "{{ tpl .Values.tplsrc . }} | {{ tpl .Values.labels $ }}",
    "{{ default \"d\" .Values.empty }} {{ .Values.empty | default \"p\" }} "
    "{{ .Values.name | default \"q\" }}",
    "{{ .Values.name | quote }} {{ .Values.name | squote }} {{ quote .Values.n }}",
    "{{ .Values.name | upper }} {{ upper .Values.name | lower }} {{ .Values.text | title }}",
    "{{ .Values.text | trim }}|{{ trimSuffix \"ld  \" .Values.text }}|"
    "{{ .Values.text | trimPrefix \"  He\" }}",
    "{{ trunc 3 .Values.name }} {{ trunc -2 .Values.name }} {{ .Values.name | trunc 63 }}",
    "{{ replace \"e\" \"E\" .Values.name }} {{ repeat 3 .Values.name }}",
    '{{ printf "%s-%d-%q-%v-%%-%5s" .Values.name 7 "q" .Values.on "pad" }}',
    '{{ printf "%f %g %x %s" 1.5 2 255 }}',
    '{{ print .Values.name 1 true }}',
    "{{ toYaml .Values.map }}\n{{ toYaml .Values.list | indent 2 }}\n"
    "{{- toYaml .Values.nested | nindent 4 }}",
    "{{ toJson .Values.map }} {{ .Values.list | toJson }}",
    "{{ (fromYaml .Values.yaml).b }} {{ fromYaml .Values.yaml | toJson }}",
    "{{ .Values.name | b64enc }} {{ .Values.name | b64enc | b64dec }} "
    "{{ .Values.name | sha256sum }}",
    "{{ eq .Values.n 3 }} {{ ne .Values.name \"x\" }} {{ lt 1 2 }} {{ le 2 2 }} "
    "{{ gt 1 2 }} {{ ge 3 1 }}",
    "{{ required \"needed\" .Values.name }} {{ fail \"no\" }}|",
    "{{ coalesce .Values.empty .Values.none .Values.name }} "
    "{{ ternary \"y\" \"n\" .Values.on }} {{ ternary \"y\" \"n\" .Values.off }}",
    "{{ hasKey .Values.map \"a\" }} {{ get .Values.map \"a\" }} {{ keys .Values.map }}",
    "{{ list 1 2 3 }} {{ dict \"a\" 1 \"b\" 2 }} {{ merge .Values.map .Values.nested }}",
    "{{ len .Values.list }} {{ first .Values.list }} {{ last .Values.list }} "
    "{{ len .Values.map }}",
    "{{ contains \"eb\" .Values.name }} {{ hasPrefix \"w\" .Values.name }} "
    "{{ hasSuffix \"b\" .Values.name }}",
    "{{ split \",\" \"a,b\" }} {{ splitList \",\" \"a,b\" }} {{ join \"-\" .Values.list }}",
    "{{ add 1 2 3 }} {{ sub 5 2 }} {{ mul 2 3 4 }} {{ div 7 2 }} {{ mod 7 2 }} "
    "{{ int .Values.num }} {{ int \"\" }}",
    "{{ toString .Values.n }} {{ kindIs \"map\" .Values.map }} {{ kindIs \"slice\" "
    ".Values.list }} {{ typeOf .Values.n }}",
    "{{ lookup \"v1\" \"Pod\" \"ns\" \"x\" }} {{ uuidv4 }} {{ now }} "
    "{{ semverCompare \">=1\" \"2\" }}",
    "{{ .Values.name | printf \"<%s>\" | upper | quote }}",
    "{{ (include \"demo.arg\" .Values.n) | trim }} {{ not (eq .Values.n 2) }}",
    "{{ nosuchfunc .Values.name }}|{{ .Values.name | nosuchfunc }}",
    "{{ if .Values.on }}unclosed",
    "{{ end }}",
    "{{ range .Values.list }}{{ else }}{{ else }}{{ end }}",
    "{{ .Values.list.0 }} {{ index .Values.list 1 }}",
]
PRINTF = [("%s", ("a",)), ("%d", (3,)), ("%q", ('x"y',)), ("%v-%v", (True, None)),
          ("%5.2f", (1.5,)), ("%g", (2,)), ("%%", ()), ("%s %s", ("only",)), ("tail %", ()),
          ("%x", (255,)), ("%-3s|", ("a",)), ("%d", ("7",))]


def outcome(fn, *args):
    try:
        return ("ok", norm(fn(*args)))
    except Exception as e:  # the error is part of the contract
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("i", range(len(SNIPPETS)))
def test_tokens_and_parse_tree_equal_jax(i):
    src = SNIPPETS[i]
    assert helm._tokenize(src) == jax_helm._tokenize(src)
    assert (outcome(lambda: helm._parse(helm._tokenize(src)))
            == outcome(lambda: jax_helm._parse(jax_helm._tokenize(src))))


@pytest.mark.parametrize("i", range(len(SNIPPETS)))
def test_rendered_snippet_equals_jax(i):
    src = SNIPPETS[i]
    mine = outcome(lambda: helm.Renderer(VALUES, META, DEFINES).render(src))
    assert mine == outcome(lambda: jax_helm.Renderer(VALUES, META, DEFINES).render(src))


def test_every_function_is_in_both_tables():
    assert list(helm._ALL_FUNCS) == list(jax_helm._ALL_FUNCS)
    used = " ".join(SNIPPETS)
    assert all(name in used for name in helm._ALL_FUNCS)


@pytest.mark.parametrize("fmt,args", PRINTF)
def test_go_printf_equals_jax(fmt, args):
    assert outcome(helm._go_printf, fmt, args) == outcome(jax_helm._go_printf, fmt, args)


def seeded_charts(seed: int) -> dict[str, bytes]:
    rng = random.Random(seed)
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        for i in range(3):
            write_chart(root / "charts", f"app{i}", rng, i,
                        SAMPLES["github-pat"] if i == 0 else None)
        return {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*")
                if p.is_file()}


@pytest.mark.parametrize("seed", range(6))
def test_seeded_charts_render_byte_for_byte(seed):
    files = seeded_charts(seed)
    mine = helm.render_charts(files)
    assert mine == jax_helm.render_charts(files)
    assert {p for p in mine if p.endswith("deployment.yaml")} == {
        f"charts/app{i}/templates/deployment.yaml" for i in range(3)}
    mcs = MisconfScanner().scan_files(sorted(files.items()))
    assert [m.to_dict() for m in mcs] == [m.to_dict() for m in
                                          JaxScanner().scan_files(sorted(files.items()))]
    assert HELM_IDS <= {f.id for m in mcs for f in m.failures}


def test_the_jax_tests_chart_renders_byte_for_byte():
    files = _chart_files()
    mine = helm.render_charts(files)
    assert mine == jax_helm.render_charts(files) and len(mine) == 2


def test_chart_lane_ownership_equals_jax():
    """The JAX regression test's tree: a chart's values, a manifest and a
    JSON manifest beside its templates feed the render; a Dockerfile in the
    chart and a manifest outside it keep their own pass."""
    files = dict(_chart_files())
    pod = (b"apiVersion: v1\nkind: Pod\nmetadata:\n  name: p\nspec:\n  containers:\n"
           b"    - name: c\n      image: busybox\n      securityContext:\n"
           b"        privileged: true\n")
    files.update({"webapp/extra-pod.yaml": pod, "standalone-pod.yaml": pod,
                  "webapp/Dockerfile": b"FROM busybox\nUSER root\nCMD [\"sh\"]\n",
                  "webapp/extra-pod.json": json.dumps(
                      {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "pj"},
                       "spec": {"containers": [{"name": "c", "image": "busybox",
                                                "securityContext": {"privileged": True}}]}}
                  ).encode()})
    mine = MisconfScanner().scan_files(list(files.items()))
    assert [m.to_dict() for m in mine] == [
        m.to_dict() for m in JaxScanner().scan_files(list(files.items()))]
    by_file = {m.file_path: m.file_type for m in mine}
    assert by_file["webapp/extra-pod.yaml"] == by_file["webapp/extra-pod.json"] == "helm"
    assert by_file["webapp/Dockerfile"] == "dockerfile"
    assert by_file["standalone-pod.yaml"] == "kubernetes"
    assert "webapp/values.yaml" not in by_file


def test_a_chart_that_does_not_parse_is_skipped_as_in_jax(caplog):
    files = {**_chart_files(),
             "webapp/templates/bad.yaml": b"a: {{ if .Values.x }}\n",
             "webapp/templates/fn.yaml": b"a: {{ derivePassword 1 \"long\" .Values.x }}\n",
             "broken/Chart.yaml": b"apiVersion: v2\nname: [unclosed\n",
             "broken/values.yaml": b"a: [1,\n",
             "broken/templates/x.yaml": b"kind: Pod\nname: {{ .Values.a }}\n"}
    mine = helm.render_charts(files)
    assert mine == jax_helm.render_charts(files)
    assert "webapp/templates/deployment.yaml" in mine  # the rest still renders
    scanned = [m.to_dict() for m in MisconfScanner().scan_files(list(files.items()))]
    assert scanned == [m.to_dict() for m in JaxScanner().scan_files(list(files.items()))]


# -- the CLI: an incremental rescan and the fleet ----------------------------------


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("helm-cli")
    tree = base / "tree"
    write_iac_tree(tree, 11, secrets={"github": SAMPLES["github-pat"]})
    jax_checks_for("dockerfile")  # the JAX registry loaded whole, once
    return {"base": base, "tree": tree}


def test_incremental_rescan_of_a_chart_equals_jax(env, wd, tmp_path):
    """A chart is one unit: an edit in its ``values.yaml`` re-analyzes the
    chart's unit alone, and both packages' rescans give the full scan's
    report."""
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
        return assert_json_equal(*outs), json.loads(stats.read_text())

    first, st = step("--incremental")
    assert st["units_analyzed"] == st["units_total"] > 1
    values = tree / "charts" / "svc1" / "values.yaml"
    values.write_text(values.read_text().replace("privileged: false", "privileged: true")
                      + "extra: 1\n")
    edited, st = step("--since-last")
    assert st["units_analyzed"] == 1
    full, _ = step()
    assert edited["Results"] == full["Results"]
    assert "KSV017" in failed_ids(edited)["charts/svc1/templates/deployment.yaml"]


def port_replica(admission: bool):
    adm = resolve_admission({"max_concurrent_scans": 2 if admission else 0})
    return start_server(cache=new_cache("memory"), device="cpu", admission=adm)


def jax_replica(admission: bool):
    adm = jax_resolve_admission({"max_concurrent_scans": 2 if admission else 0})
    return jax_start_server(cache=jax_new_cache("memory", None), admission=adm)


FLEET = ["--fleet-speculate", "0", "--fleet-telemetry-interval", "0",
         "--fleet-split-threshold", "0"]


@pytest.mark.parametrize("coordinator,mode", [("jax", "async"), ("jax", "sync"),
                                              ("port", "async"), ("port", "sync")])
def test_fleet_misconfig_equals_the_local_scan(env, wd, coordinator, mode):
    """``--fleet`` with ``misconfig,secret``: a JAX coordinator over two port
    replicas, and the port's coordinator over two JAX replicas, with async
    shard jobs (admission on) or sync shards (off), give the local scan's
    ``Results``. The tree holds no Terraform module split across shards."""
    make = port_replica if coordinator == "jax" else jax_replica
    servers = [make(mode == "async") for _ in range(2)]
    hosts = ",".join(f"127.0.0.1:{port}" for _, port in servers)
    try:
        local, _, rc, _ = run_both(wd, "fs", env["tree"], "--scanners", "misconfig,secret")
        assert rc == 0
        main, dev = ((cli.main, ["--device", "cpu"]) if coordinator == "port"
                     else (jax_cli.main, ["--backend", "cpu"]))
        out = wd / "fleet.json"
        assert main(["fs", *dev, "--format", "json", "-o", str(out), "-q", "--cache-dir",
                     str(wd / "cf"), "--scanners", "misconfig,secret", "--fleet", hosts,
                     *FLEET, str(env["tree"])]) == 0
    finally:
        for httpd, _ in servers:
            httpd.shutdown()
    doc = assert_json_equal(out.read_text(), local)
    assert {"cloudformation", "helm"} <= {r["Type"] for r in doc["Results"]}
    assert sum(h.service.metrics.scans.value() for h, _ in servers) > 0


def test_fleet_ignores_the_misconfig_settings_with_a_warning(env, wd, capsys):
    """``--misconfig-scanners`` reaches no replica (a shard carries none),
    so the fleet scans every type, as the JAX fleet does; the port says so
    in one warning."""
    httpd, port = port_replica(True)
    try:
        outs = []
        for tag, main, dev in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_cli.main, ["--backend", "cpu", "-q"])):
            out = wd / f"{tag}-fleet.json"
            capsys.readouterr()
            assert main(["fs", *dev, "--format", "json", "-o", str(out), "--cache-dir",
                         str(wd / f"c-{tag}"), "--scanners", "misconfig",
                         "--misconfig-scanners", "dockerfile", "--fleet",
                         f"127.0.0.1:{port}", *FLEET, str(env["tree"])]) == 0
            outs.append(out.read_text())
            if tag == "port":
                err = capsys.readouterr().err
    finally:
        httpd.shutdown()
    doc = assert_json_equal(*outs)
    assert "helm" in {r["Type"] for r in doc["Results"]}
    assert err.count("--misconfig-scanners is ignored by the fleet's replicas") == 1


@pytest.mark.parametrize("path", [rpc.SCANNER_SCAN, rpc.SCAN_SUBMIT])
def test_a_misconfig_shard_gives_the_jax_replicas_blob(env, path):
    """The shard that answered 400 before: sent to a port and a JAX server,
    sync and as an async job, it gives the same ``Blobs``."""
    from trivy_tpu_torch.rpc.client import RemoteDriver
    from trivy_tpu_torch.scanner import ScanOptions

    shard = {"Kind": "fs", "Root": str(env["tree"]), "Scanners": ["misconfig", "secret"],
             "Paths": sorted(str(p.relative_to(env["tree"])) for p in env["tree"].rglob("*")
                             if p.is_file() and "charts/" in str(p)),
             "Backend": "cpu"}
    blobs = []
    for make in (port_replica, jax_replica):
        httpd, port = make(True)
        try:
            base = f"http://127.0.0.1:{port}"
            if path == rpc.SCANNER_SCAN:
                code, doc = post(base + path, {"Target": "t", "Shard": shard})
                assert code == 200, doc
            else:
                driver = RemoteDriver(base, retries=0)
                sub = driver.submit("t", "", [], ScanOptions(scanners=["misconfig", "secret"]),
                                    shard=shard)
                doc = driver.wait_result(sub["JobID"], timeout=120)
            blobs.append(doc["Blobs"])
        finally:
            httpd.shutdown()
    assert blobs[0] == blobs[1]
    assert blobs[0][0]["BlobInfo"]["Misconfigurations"]
