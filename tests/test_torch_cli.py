"""The port's ``fs`` command against the JAX package's (secret, license
and fused scans), plus the port's rules: it imports nothing of JAX or of
the JAX package, and every entry point refuses to run without CUDA unless
the CPU was asked for."""

import ast
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.secret_samples import SAMPLES
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu_torch import cli
from trivy_tpu_torch.detector.library import _upload
from trivy_tpu_torch.device import resolve
from trivy_tpu_torch.fanal.license import LicenseAnalyzer
from trivy_tpu_torch.licensing.classify import LicenseClassifier
from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS
from trivy_tpu_torch.licensing.fused import get_gate_fn
from trivy_tpu_torch.ops.bytes_gate_cuda import CudaBytesGate
from trivy_tpu_torch.ops.bytes_score_cuda import CudaBytesScorer
from trivy_tpu_torch.ops.gram_gate import build_gram_gate_fn
from trivy_tpu_torch.ops.ngram_score import get_bytes_scorer
from trivy_tpu_torch.ops.match_cuda import build_match_fn_cuda
from trivy_tpu_torch.ops.prefilter import build_prefilter_fn
from trivy_tpu_torch.ops.verscmp import batch_compare
from trivy_tpu_torch.ops.verscmp_cuda import check_ops_gather
from trivy_tpu_torch.secret.device_compile import compile_rules
from trivy_tpu_torch.secret.rules import builtin_rules
from trivy_tpu_torch.secret.scanner import TorchSecretScanner

REPO = Path(__file__).resolve().parents[1]

CONFIG = """\
rules:
  - id: company-token
    category: Company
    title: Company token
    severity: HIGH
    regex: cmp_[0-9a-f]{16}
    keywords: [cmp_]
disable-rules: [mailgun-token]
"""


def make_tree(root: Path) -> None:
    (root / "src").mkdir()
    (root / "node_modules" / "x").mkdir(parents=True)
    (root / "tests").mkdir()
    (root / "src" / "a.py").write_text(f"x = 1\nkey = '{SAMPLES['github-pat']}'\n")
    (root / "win").mkdir()
    (root / "win" / "crlf.env").write_bytes(
        b"A=1\r\nAWS=" + SAMPLES["aws-access-key-id"].encode() + b"\r\nB=2\r\n")
    (root / "src" / "co.txt").write_text("token cmp_0123456789abcdef\n")
    (root / "src" / "big.conf").write_text(
        ("filler line\n" * 3000) + SAMPLES["slack-access-token"] + "\n" + ("z\n" * 2000))
    (root / "node_modules" / "x" / "k.js").write_text(SAMPLES["github-pat"] + "\n")
    (root / "package-lock.json").write_text(SAMPLES["github-pat"] + "\n")
    (root / "tests" / "t.txt").write_text(SAMPLES["github-pat"] + "\n")
    (root / "blob.dat").write_bytes(b"\x00\x01\x02" + SAMPLES["github-pat"].encode())
    (root / "m.pyc").write_bytes(b"\x00\x01\x02\x03" + SAMPLES["github-pat"].encode() + b"\x00")
    (root / "tiny").write_text("short")
    (root / "trivy-secret.yaml").write_text(CONFIG)


def make_license_tree(root: Path) -> None:
    """The secret tree plus license files (every full text, raw, re-wrapped
    and CRLF, across the width rungs), source files with license headers, a
    license file the secret feed never carries (skipped dir, binary, tiny)
    and one over the license analyzer's size cap."""
    make_tree(root)
    keys = sorted(FULL_TEXTS)
    for i, k in enumerate(keys):
        t = FULL_TEXTS[k]
        form = i % 3
        if form == 1:
            words = t.split(" ")
            t = "\n".join(" ".join(words[j : j + 11]) for j in range(0, len(words), 11))
        elif form == 2:
            t = t.replace(". ", ".\r\n")
        d = root / "deps" / f"dep{i}"
        d.mkdir(parents=True)
        (d / ["LICENSE", "COPYING.txt", "LICENSE-" + k][form]).write_text(t, newline="")
    (root / "src" / "hdr.py").write_text(
        "# Permission is hereby granted, free of charge, to any person obtaining a copy\n"
        "# THE SOFTWARE IS PROVIDED \"AS IS\", WITHOUT WARRANTY OF ANY KIND\n"
        "# The above copyright notice and this permission notice shall be included\n"
        + "x = 2\n" * 40)
    (root / "src" / "apache.go").write_text(
        "// " + FULL_TEXTS["Apache-2.0"][:3000] + "\npackage main\n")
    (root / "node_modules" / "x" / "LICENSE").write_text(FULL_TEXTS["ISC"])
    (root / "src" / "NOTICE").write_bytes(b"\x00\x01" + FULL_TEXTS["Zlib"].encode())
    (root / "COPYING").write_text("MIT")
    (root / "LICENSE.md").write_text(FULL_TEXTS["MIT"] + "\n" + "filler words " * 50000)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    make_tree(root)
    return root


@pytest.fixture(scope="module")
def license_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("lictree")
    make_license_tree(root)
    return root


def run(main, tree, out, *extra, scanners="secret"):
    assert main(["fs", "--scanners", scanners, "--format", "json", "-o", str(out),
                 "-q", *extra, str(tree)]) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", ["default", "config", "skips"])
def test_fs_results_equal_jax_cli(tree, tmp_path, case):
    extra = {
        "default": [],
        "config": ["--secret-config", str(tree / "trivy-secret.yaml")],
        "skips": ["--skip-dirs", "**/win", "--skip-files", "src/*.conf"],
    }[case]
    mine = run(cli.main, tree, tmp_path / "port.json", "--device", "cpu",
               "--stats-out", str(tmp_path / "stats.json"), *extra)
    ref = run(jax_cli.main, tree, tmp_path / "jax.json", "--backend", "cpu", *extra)
    assert mine["Results"] == ref["Results"]
    assert {k: mine[k] for k in ("SchemaVersion", "ArtifactType", "Metadata")} == \
        {k: ref[k] for k in ("SchemaVersion", "ArtifactType", "Metadata")}
    targets = {r["Target"] for r in mine["Results"]}
    assert {"src/a.py", "m.pyc"} <= targets
    assert ("src/co.txt" in targets) == (case == "config")
    assert ("src/big.conf" in targets) == (case != "skips")
    assert ("win/crlf.env" in targets) == (case != "skips")
    if case != "skips":
        crlf = next(r for r in mine["Results"] if r["Target"] == "win/crlf.env")
        assert "\r" not in json.dumps(crlf) and crlf["Secrets"][0]["StartLine"] == 2
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["files_scanned"] >= 5 and stats["rows"] >= 1


@pytest.mark.parametrize("scanners,extra", [
    ("license", []),
    ("license", ["--license-full"]),
    ("secret,license", []),
    ("secret,license", ["--license-full"]),
    ("secret,license", ["--license-full", "--no-shared-arena"]),
])
def test_fs_license_results_equal_jax_cli(license_tree, tmp_path, scanners, extra):
    mine = run(cli.main, license_tree, tmp_path / "port.json", "--device", "cpu",
               "--stats-out", str(tmp_path / "stats.json"), *extra, scanners=scanners)
    ref = run(jax_cli.main, license_tree, tmp_path / "jax.json", "--backend", "cpu", *extra,
              scanners=scanners)
    assert mine["Results"] == ref["Results"]
    lic = [r for r in mine["Results"] if r["Class"] == "license-file"]
    assert len(lic) == 1 and lic[0]["Target"] == "Loose File License(s)"
    names = {(d["FilePath"], d["Name"]) for d in lic[0]["Licenses"]}
    assert ("node_modules/x/LICENSE", "ISC") in names and len(names) >= 22
    assert any(p == "src/hdr.py" for p, _ in names) == ("--license-full" in extra)
    assert any(r["Class"] == "secret" for r in mine["Results"]) == ("secret" in scanners)
    stats = json.loads((tmp_path / "stats.json").read_text())
    fused = scanners == "secret,license" and "--no-shared-arena" not in extra
    assert ("files_covered" in stats) == fused
    if fused:
        assert stats["license_rows_gated"] > 0 and stats["files_flagged"] >= 20


def test_fs_table_format_with_licenses(license_tree, capsys):
    assert cli.main(["fs", "--device", "cpu", "-q", "--scanners", "secret,license",
                     str(license_tree)]) == 0
    out = capsys.readouterr().out
    assert "Loose File License(s) (license)" in out and "│ MIT" in out and "github-pat" in out


def test_fs_rejects_unknown_scanners(tree):
    with pytest.raises(SystemExit):
        cli.main(["fs", "--device", "cpu", "-q", "--scanners", "secret,rbac", str(tree)])


def test_fs_table_format(tree, tmp_path, capsys):
    assert cli.main(["fs", "--device", "cpu", "-q", str(tree)]) == 0
    out = capsys.readouterr().out
    assert "src/a.py" in out and "github-pat" in out


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "trivy_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "trivy_tpu"), f"{f.name} imports {name}"


def test_entry_points_raise_without_cuda(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    compiled = compile_rules(builtin_rules())
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSecretScanner()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_match_fn_cuda(compiled, 1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_prefilter_fn(compiled, 1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["fs", "-q", str(tree)])
    for scanners in ("license", "secret,license"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["fs", "-q", "--scanners", scanners, str(tree)])
    with pytest.raises(RuntimeError, match="CUDA"):
        LicenseClassifier()
    with pytest.raises(RuntimeError, match="CUDA"):
        LicenseAnalyzer("license-file", "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_gate_fn(1024, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_bytes_scorer(lambda: None)
    lut = np.zeros(256, np.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_gram_gate_fn(1024, lut, np.zeros(1, np.int64), np.zeros(0, np.int64), 1, 1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaBytesGate(lut, np.zeros(1 << 22, np.uint8), np.zeros(1 << 22, np.uint8), "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaBytesScorer(lut, np.zeros(1, np.uint32), np.zeros((1, 2), np.float32), 1, 1, 1, 5,
                        "cuda")
    bom = tree / "bom.json"
    bom.write_text(json.dumps({"bomFormat": "CycloneDX", "components": []}))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["sbom", "-q", "--db-repository", str(tree), str(bom)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.scan_sbom(str(bom), db=object())
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_compare("npm", [("1.0.0", "1.0.1")], device="cuda")
    one = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        _upload(one.numpy(), "cuda", Counter())
    with pytest.raises(ValueError, match="device"):
        check_ops_gather(one.to("meta"), one.to("meta"), *[torch.zeros(1, dtype=torch.int32,
                                                                       device="meta")] * 3)
    with pytest.raises(ValueError):
        resolve("mps")
    assert resolve("cpu").type == "cpu"
