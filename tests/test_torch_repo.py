"""``repo`` of the port against the JAX package's: a local git repository
cloned through a ``file://`` URL at a branch, a tag and a commit, the
mutually exclusive refs, a clone that fails, and a plain path target
scanned in place. Each checkout is a temp directory of its own, so the
report names (``ArtifactName`` and the OS section's target) are set aside;
``Results`` and ``Metadata`` are otherwise equal, exactly."""

import json
import os
import shutil
import subprocess
from pathlib import Path

import pytest

from tests.dbtest import build_db
from tests.secret_samples import SAMPLES
from tests.test_torch_filter import make_tree
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu_torch import cli

GIT_ENV = {"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@example.com",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@example.com",
           "GIT_CONFIG_NOSYSTEM": "1", "GIT_CONFIG_GLOBAL": "/dev/null"}


def git(repo: Path, *args: str) -> str:
    return subprocess.run(["git", *args], cwd=repo, check=True, capture_output=True, text=True,
                          env={"PATH": os.environ["PATH"], **GIT_ENV}).stdout.strip()


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """``main``: the filter tests' tree (tag ``v1``), then a commit adding a
    second lockfile; ``feature`` off ``v1`` adds a secret."""
    if shutil.which("git") is None:
        pytest.skip("git not available")
    base = tmp_path_factory.mktemp("repo")
    root = base / "src"
    root.mkdir()
    make_tree(root)
    git(root, "init", "-q", "-b", "main")
    git(root, "add", "-A")
    git(root, "commit", "-q", "-m", "one")
    git(root, "tag", "v1")
    first = git(root, "rev-parse", "HEAD")
    git(root, "checkout", "-q", "-b", "feature")
    (root / "feature.env").write_text(f"GITHUB={SAMPLES['github-pat']}\n")
    git(root, "add", "-A")
    git(root, "commit", "-q", "-m", "feature")
    git(root, "checkout", "-q", "main")
    (root / "app").mkdir()
    (root / "app" / "package-lock.json").write_text(json.dumps({
        "lockfileVersion": 3, "packages": {"node_modules/lodash": {"version": "4.17.15"}}}))
    git(root, "add", "-A")
    git(root, "commit", "-q", "-m", "two")
    return {"root": root, "url": f"file://{root}", "first": first, "db": build_db(base)}


@pytest.fixture
def wd(tmp_path, monkeypatch):
    d = tmp_path / "wd"
    d.mkdir()
    monkeypatch.chdir(d)
    return d


def run_both(wd: Path, target: str, *args: str) -> tuple[dict, dict, int, int]:
    mine_out, ref_out = wd / "port.json", wd / "jax.json"
    rc1 = cli.main(["repo", "--device", "cpu", "--format", "json", "-o", str(mine_out), "-q",
                    "--cache-dir", str(wd / "c1"), *args, target])
    rc2 = jax_cli.main(["repo", "--backend", "cpu", "--format", "json", "-o", str(ref_out), "-q",
                        "--cache-dir", str(wd / "c2"), *args, target])
    return (json.loads(mine_out.read_text()) if mine_out.exists() else {},
            json.loads(ref_out.read_text()) if ref_out.exists() else {}, rc1, rc2)


def unnamed(report: dict) -> dict:
    """``report`` with its checkout path (in the name and the OS target)
    replaced by ``<repo>``."""
    return json.loads(json.dumps(report).replace(report["ArtifactName"], "<repo>"))


def secret_targets(report: dict) -> set:
    return {r["Target"] for r in report["Results"] if r.get("Secrets")}


@pytest.mark.parametrize("ref,scanners", [
    ([], "vuln,secret,license"), (["--branch", "feature"], "secret"),
    (["--tag", "v1"], "vuln,secret"), (["--commit", "first"], "vuln"),
], ids=["default", "branch", "tag", "commit"])
def test_remote_repo_equals_jax(repo, wd, ref, scanners):
    ref = [repo["first"] if r == "first" else r for r in ref]
    mine, jax, rc1, rc2 = run_both(wd, repo["url"], *ref, "--scanners", scanners,
                                   "--db-repository", repo["db"])
    assert rc1 == rc2 == 0
    mine, jax = unnamed(mine), unnamed(jax)
    assert mine["Results"] == jax["Results"] and mine["Metadata"] == jax["Metadata"]
    assert mine["ArtifactType"] == jax["ArtifactType"] == "filesystem"
    assert mine["Results"]
    if "secret" in scanners:
        assert ("feature.env" in secret_targets(mine)) == (ref[:1] == ["--branch"])
    lockfiles = {r["Target"] for r in mine["Results"] if r["Class"] == "lang-pkgs"}
    if "vuln" in scanners:
        assert ("app/package-lock.json" in lockfiles) == (ref == [])


def test_mutually_exclusive_refs_exit_1(repo, wd):
    mine, jax, rc1, rc2 = run_both(wd, repo["url"], "--branch", "main", "--tag", "v1")
    assert rc1 == rc2 == 1 and mine == jax == {}


def test_failed_clone_exits_1(repo, wd):
    mine, jax, rc1, rc2 = run_both(wd, f"file://{wd}/no-such-repo")
    assert rc1 == rc2 == 1 and mine == jax == {}


def test_path_target_scanned_in_place(repo, wd):
    """A path is no URL: both scan it where it lies, named by it, as ``fs``
    does; the refs are ignored."""
    target = str(repo["root"])
    mine, jax, rc1, rc2 = run_both(wd, target, "--branch", "feature", "--scanners",
                                   "vuln,secret", "--db-repository", repo["db"])
    assert rc1 == rc2 == 0
    assert mine["Results"] == jax["Results"] and mine["Metadata"] == jax["Metadata"]
    assert mine["ArtifactName"] == jax["ArtifactName"] == target
    fs_out = wd / "fs.json"
    assert cli.main(["fs", "--device", "cpu", "--format", "json", "-o", str(fs_out), "-q",
                     "--scanners", "vuln,secret", "--db-repository", repo["db"], target]) == 0
    fs = json.loads(fs_out.read_text())
    assert fs["Results"] == mine["Results"] and fs["Metadata"] == mine["Metadata"]
    # the working tree is main's: the feature branch's secret is not there
    assert "feature.env" not in secret_targets(mine)
