"""The port's incremental scanning against the JAX package's
(``trivy_tpu/incremental``): the unit planner, the git helpers, the unit
artifact at every step of the re-scan ladder (cold, unchanged, one edit, an
add and a delete, touched mtimes, a Helm chart, a changed
``--secret-config``, a dirty-worktree manifest, ``--diff-base``), and the
CLI's ``--incremental``, ``--since-last`` and ``--diff-base`` on ``fs``,
``rootfs`` and ``repo``.

Both sides run on the CPU (the JAX artifact with the JAX CLI's analyzer
options on ``backend="cpu"``, the port's ``scan_fs`` with ``device="cpu"``)
over trees made from a numpy seed: the secret samples of
``tests/secret_samples.py`` under the two rules of a restricted
``--secret-config``, a lockfile, an installed OS package DB, a license text
and a Helm chart. ``Results``, ``Metadata`` and the reuse counts
(``last_stats``) must be equal, and with ``vuln`` or ``license`` among the
scanners the unit keys too; no float is on this path, so equality is exact.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.dbtest import build_db
from tests.secret_samples import SAMPLES
from tests.test_analyzers import DPKG_STATUS
from tests.test_torch_match import few_torch_threads, port_logs_propagate  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu import commands as jax_commands
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu.db import load_default_db
from trivy_tpu.fleet.plan import group_units as jax_group_units
from trivy_tpu.incremental import IncrementalOptions as JaxIncrementalOptions
from trivy_tpu.incremental import manifest as jax_manifest
from trivy_tpu.incremental.fs import IncrementalFSArtifact as JaxIncrementalFSArtifact
from trivy_tpu.scanner import ScanOptions as JaxScanOptions
from trivy_tpu.scanner import Scanner as JaxScanner
from trivy_tpu.scanner.local_driver import LocalDriver as JaxLocalDriver
from trivy_tpu_torch import cli
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.db import VulnDB
from trivy_tpu_torch.fanal.scan import ScanAnalyzers
from trivy_tpu_torch.fleet.plan import group_units
from trivy_tpu_torch.incremental import IncrementalOptions
from trivy_tpu_torch.incremental import manifest
from trivy_tpu_torch.incremental.fs import IncrementalFSArtifact
from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS

RULES = ("github-pat", "slack-access-token")
RESTRICTED = "enable-builtin-rules: [github-pat, slack-access-token]\n"
ALL = ("vuln", "secret", "license")
GIT_ENV = {"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t", "GIT_COMMITTER_NAME": "t",
           "GIT_COMMITTER_EMAIL": "t@t", "GIT_TERMINAL_PROMPT": "0",
           "GIT_CONFIG_GLOBAL": os.devnull, "GIT_CONFIG_NOSYSTEM": "1"}


def write(root: Path, rel: str, data: bytes | str) -> None:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(data.encode() if isinstance(data, str) else data)


def make_tree(base: Path, n_dirs: int = 4, seed: int = 0, rich: bool = False) -> Path:
    """``n_dirs`` units of two files each (a credential with a seeded
    secret sample, a seeded source file); ``rich`` adds a lockfile with
    vulnerable packages, a debian root, a ``node_modules`` package, a
    license text and a Helm chart with a nested chart."""
    rng = np.random.default_rng(seed)
    root = base / "tree"
    for i in range(n_dirs):
        rid = RULES[int(rng.integers(len(RULES)))]
        write(root, f"pkg{i:02d}/cred.txt", f"svc{i} token {SAMPLES[rid]}\n")
        write(root, f"pkg{i:02d}/data.py",
              "".join(f"x{j} = {int(v)}\n" for j, v in enumerate(rng.integers(0, 999, 40))))
    if rich:
        write(root, "web/package-lock.json", json.dumps({"lockfileVersion": 3, "packages": {
            "node_modules/lodash": {"version": "4.17.15"},
            "node_modules/minimist": {"version": "1.2.0"}}}))
        write(root, "web/node_modules/left-pad/package.json",
              json.dumps({"name": "left-pad", "version": "1.3.0", "license": "WTFPL"}))
        write(root, "etc/os-release", 'ID=debian\nVERSION_ID="12"\n')
        write(root, "var/lib/dpkg/status", DPKG_STATUS)
        lic = sorted(FULL_TEXTS)[int(rng.integers(len(FULL_TEXTS)))]
        write(root, "lic/LICENSE", FULL_TEXTS[lic])
        write(root, "chart/Chart.yaml", "name: c\nversion: 1.0.0\n")
        write(root, "chart/templates/d.yaml", "kind: Deployment\n")
        write(root, "chart/charts/sub/Chart.yaml", "name: sub\nversion: 0.1.0\n")
        write(root, "chart/charts/sub/values.yaml", f"token: {SAMPLES['github-pat']}\n")
    return root


def git(root: Path, *args: str) -> str:
    return subprocess.run(["git", "-c", "init.defaultBranch=main", *args], cwd=root,
                          check=True, capture_output=True, text=True,
                          env={**os.environ, **GIT_ENV}).stdout.strip()


def commit_all(root: Path, msg: str = "base") -> str:
    if not (root / ".git").exists():
        git(root, "init", "-q")
    git(root, "add", "-A")
    git(root, "commit", "-qm", msg)
    return git(root, "rev-parse", "HEAD")


def touch_all(root: Path, ns: int) -> None:
    """Every file's mtime set to ``ns`` (a fresh checkout), ``.git`` aside."""
    for d, dirs, names in os.walk(root):
        dirs[:] = [x for x in dirs if x != ".git"]
        for n in names:
            os.utime(os.path.join(d, n), ns=(ns, ns))


def edit(path: Path, text: str, ns: int) -> None:
    path.write_text(text)
    os.utime(path, ns=(ns, ns))


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    d = build_db(tmp_path_factory.mktemp("incr-db"))
    return {"port": VulnDB.load(d), "jax": load_default_db(d, None), "dir": d}


@pytest.fixture
def wd(tmp_path, monkeypatch):
    """A fresh working directory holding the restricted rule file; git looks
    for no repository above ``tmp_path``."""
    d = tmp_path / "wd"
    d.mkdir()
    (d / "trivy-secret.yaml").write_text(RESTRICTED)
    monkeypatch.chdir(d)
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path))
    return d


def digest(unit_keys) -> str:
    return hashlib.sha256("\n".join(sorted(unit_keys)).encode()).hexdigest()


COUNTS = cli.INCREMENTAL_COUNTERS


class Pair:
    """One cache per package over one tree; each :meth:`scan` runs the
    port's incremental ``scan_fs`` and the JAX artifact with the same
    options and holds them equal."""

    def __init__(self, root: Path, dbs, scanners=ALL, cfg: str | None = None,
                 keys_equal: bool = True):
        self.root, self.dbs, self.scanners = str(root), dbs, tuple(scanners)
        self.cfg = cfg or os.path.abspath("trivy-secret.yaml")
        self.keys_equal = keys_equal
        self.port_cache, self.jax_cache = new_cache("memory"), jax_new_cache("memory")

    def jax(self, **incr) -> tuple[dict, dict]:
        opt = jax_commands._artifact_option(None, {
            "scanners": list(self.scanners), "backend": "cpu", "secret_config": self.cfg})
        art = JaxIncrementalFSArtifact(self.root, self.jax_cache, opt,
                                       JaxIncrementalOptions(enabled=True, **incr))
        driver = JaxLocalDriver(self.jax_cache, vuln_client=self.dbs["jax"])
        report = JaxScanner(art, driver).scan_artifact(JaxScanOptions(scanners=list(self.scanners)))
        return report.to_dict(), art.last_stats

    def port(self, **incr) -> tuple[dict, dict]:
        report, stats = cli.scan_fs(self.root, config_path=self.cfg, device="cpu",
                                    scanners=self.scanners, db=self.dbs["port"],
                                    cache=self.port_cache,
                                    incremental=IncrementalOptions(enabled=True, **incr))
        return report.to_dict(), stats

    def scan(self, **incr) -> tuple[dict, dict]:
        mine, stats = self.port(**incr)
        ref, last = self.jax(**incr)
        assert mine["Results"] == ref["Results"]
        assert mine["Metadata"] == ref["Metadata"]
        assert {k: stats[k] for k in COUNTS} == {k: last[k] for k in COUNTS}
        assert (stats["unit_set"] == digest(last["unit_keys"])) is self.keys_equal
        return mine, stats

    def full(self) -> dict:
        """The port's one-blob scan of the tree."""
        report, _ = cli.scan_fs(self.root, config_path=self.cfg, device="cpu",
                                scanners=self.scanners, db=self.dbs["port"])
        return report.to_dict()


def same(a: dict, b: dict) -> bool:
    """Equal reports apart from the clock's ``CreatedAt``."""
    return {**a, "CreatedAt": ""} == {**b, "CreatedAt": ""}


def secret_targets(report: dict) -> set:
    return {(r["Target"], s["RuleID"]) for r in report["Results"] for s in r.get("Secrets", [])}


# -- the unit planner and the git helpers ---------------------------------------


PATH_PARTS = st.sampled_from(["a", "b", "chart", "sub", "templates", "x.y"])
FILE_NAMES = st.sampled_from(["Chart.yaml", "values.yaml", "f.txt", "go.mod", "LICENSE"])


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.lists(PATH_PARTS, max_size=4), FILE_NAMES,
                          st.integers(0, 1 << 20)), max_size=40))
def test_group_units_equals_jax(files):
    """Random trees with charts nested at any depth (the root too): the
    port's units equal the JAX planner's."""
    rels = {"/".join([*parts, name]): size for parts, name, size in files}
    items = sorted(rels.items())
    assert group_units(items) == jax_group_units(items)


def test_group_units_keeps_nested_charts_whole():
    files = [("chart/Chart.yaml", 1), ("chart/templates/d.yaml", 2),
             ("chart/charts/sub/Chart.yaml", 3), ("chart/charts/sub/t/x.yaml", 4),
             ("other/f.txt", 5), ("top.txt", 6)]
    units = group_units(files)
    assert [(u, [r for r, _ in fs], n) for u, fs, n in units] == [
        ("", ["top.txt"], 6),
        ("chart", ["chart/Chart.yaml", "chart/templates/d.yaml"], 3),
        ("chart/charts/sub", ["chart/charts/sub/Chart.yaml", "chart/charts/sub/t/x.yaml"], 7),
        ("other", ["other/f.txt"], 5)]
    assert units == jax_group_units(files)


def test_git_helpers_equal_jax(tmp_path, monkeypatch):
    """Clean and dirty HEAD, an untracked file, an edit, and a rename taken
    as a delete and an add: the port's helpers answer as the JAX ones."""
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path))
    root = make_tree(tmp_path, n_dirs=3)
    r = str(root)
    assert manifest.git_head(r) == jax_manifest.git_head(r) == ""
    assert manifest.git_clean_head(r) == ""
    with pytest.raises(manifest.GitDiffError):
        manifest.git_resolve(r, "HEAD")
    base = commit_all(root)
    assert manifest.git_head(r) == manifest.git_clean_head(r) == base
    assert manifest.git_resolve(r, "HEAD") == jax_manifest.git_resolve(r, "HEAD") == base
    assert manifest.git_changed_paths(r, base) == set()
    (root / "new.txt").write_text("untracked\n")
    assert manifest.git_clean_head(r) == jax_manifest.git_clean_head(r) == ""
    (root / "pkg00" / "data.py").write_text("edited\n")
    git(root, "mv", "pkg01/cred.txt", "pkg01/moved.txt")
    changed = manifest.git_changed_paths(r, base)
    assert changed == jax_manifest.git_changed_paths(r, base) == {
        "new.txt", "pkg00/data.py", "pkg01/cred.txt", "pkg01/moved.txt"}
    second = commit_all(root, "second")
    assert manifest.git_changed_paths(r, base) == jax_manifest.git_changed_paths(r, base)
    assert manifest.git_changed_paths(r, second) == set()
    assert manifest.git_resolve(r, "HEAD~1") == base
    for ref in ("no-such-ref", "HEAD~5"):
        with pytest.raises(manifest.GitDiffError):
            manifest.git_resolve(r, ref)
        with pytest.raises(jax_manifest.GitDiffError):
            jax_manifest.git_resolve(r, ref)


def test_manifest_round_trip_in_every_cache(tmp_path):
    """The manifest goes through the fs and memory caches under the JAX key;
    another version is ignored."""
    for cache in (new_cache("memory"), new_cache("fs", str(tmp_path / "c"))):
        assert manifest.manifest_key("/r", "fp") == jax_manifest.manifest_key("/r", "fp")
        assert manifest.load_manifest(cache, "/r", "fp") is None
        doc = manifest.save_manifest(cache, "/r", "fp", {"a": [1, 2, "k"]}, {"": "u"}, "c0")
        assert manifest.load_manifest(cache, "/r", "fp") == doc
        cache.put_artifact(manifest.manifest_key("/r", "fp"), {**doc, "Version": 99})
        assert manifest.load_manifest(cache, "/r", "fp") is None
    names = os.listdir(tmp_path / "c" / "fanal" / "artifact")
    assert [n for n in names if n.startswith("incr-manifest")]


def test_options_from_opts_equal_jax():
    for opts in ({}, {"incremental": True}, {"since_last": True}, {"diff_base": "HEAD~1"},
                 {"diff_base": "", "since_last": False, "incremental": False}):
        mine, ref = IncrementalOptions.from_opts(opts), JaxIncrementalOptions.from_opts(opts)
        assert (mine.enabled, mine.diff_base, mine.since_last) == (
            ref.enabled, ref.diff_base, ref.since_last)


def test_split_keeps_an_unplanned_path_loudly(caplog, port_logs_propagate):
    """The batched findings go to the units of their paths; one for a path
    outside the dirty units is kept in the first unit with a warning, as in
    the JAX split, never dropped."""
    from trivy_tpu_torch.fanal.analyzer import AnalysisResult
    from trivy_tpu_torch.types import LicenseFile, Secret

    batch = AnalysisResult(secrets=[Secret("b/s.txt"), Secret("elsewhere/x.txt")],
                           licenses=[LicenseFile("license-file", "a/LICENSE")])
    units = {"a": AnalysisResult(), "b": AnalysisResult()}
    dirty = [("b", [("b/s.txt", 1)], 1), ("a", [("a/LICENSE", 1)], 1)]
    IncrementalFSArtifact._split_batch_result(batch, {"b/s.txt": "b", "a/LICENSE": "a"},
                                              units, dirty)
    assert [s.file_path for s in units["b"].secrets] == ["b/s.txt"]
    assert [s.file_path for s in units["a"].secrets] == ["elsewhere/x.txt"]
    assert [lic.file_path for lic in units["a"].licenses] == ["a/LICENSE"]
    assert "unplanned path elsewhere/x.txt" in caplog.text


def test_unit_keys_and_fingerprint_equal_jax(tmp_path, wd, dbs):
    """With ``vuln,secret,license`` the fingerprint, every unit key and the
    artifact id equal the JAX artifact's."""
    root = make_tree(tmp_path, rich=True)
    cfg = os.path.abspath("trivy-secret.yaml")
    art = IncrementalFSArtifact(str(root), new_cache("memory"),
                                ScanAnalyzers(ALL, "cpu", config_path=cfg))
    opt = jax_commands._artifact_option(None, {"scanners": list(ALL), "backend": "cpu",
                                               "secret_config": cfg})
    jax_art = JaxIncrementalFSArtifact(str(root), jax_new_cache("memory"), opt)
    assert art.fingerprint() == jax_art.fingerprint()
    ref, jax_ref = art.inspect(), jax_art.inspect()
    assert ref.blob_ids == jax_ref.blob_ids and ref.id == jax_ref.id
    assert art.last_stats == jax_art.last_stats
    assert art.stats["files_walked"] == 17 and art.stats["files_scanned"] > 0


# -- the unit artifact, step by step (the JAX TestIncrementalFS) ----------------


class TestIncrementalFS:
    def test_cold_scan_matches_full_scan(self, tmp_path, wd, dbs):
        root = make_tree(tmp_path, rich=True)
        pair = Pair(root, dbs)
        mine, stats = pair.scan()
        assert mine["Results"] == pair.full()["Results"]
        assert mine["Metadata"] == pair.full()["Metadata"]
        assert mine["Metadata"]["OS"]["Family"] == "debian"
        assert len(secret_targets(mine)) == 5
        # units: pkg00-03, web, web/node_modules/left-pad, etc, var/lib/dpkg,
        # lic, chart and its nested chart
        assert stats["units_analyzed"] == stats["units_total"] == 11
        classes = {r["Class"] for r in mine["Results"]}
        assert {"secret", "lang-pkgs", "license-file"} <= classes

    def test_unchanged_rescan_is_pure_reuse(self, tmp_path, wd, dbs):
        pair = Pair(make_tree(tmp_path), dbs)
        first, _ = pair.scan()
        again, stats = pair.scan(since_last=True)
        assert same(again, first)
        assert (stats["units_analyzed"], stats["units_reused"]) == (0, 4)
        assert (stats["files_hashed"], stats["files_stat_reused"]) == (0, 8)
        assert (stats["files_walked"], stats["files_scanned"]) == (8, 0)
        assert stats["batches"] == 0  # nothing reached the secret feed

    def test_one_changed_file_reanalyzes_one_unit(self, tmp_path, wd, dbs):
        root = make_tree(tmp_path)
        pair = Pair(root, dbs)
        pair.scan()
        edit(root / "pkg02" / "cred.txt", "rotated: nothing secret anymore\n", 10**18)
        mine, stats = pair.scan(since_last=True)
        assert (stats["units_analyzed"], stats["units_reused"]) == (1, 3)
        assert mine["Results"] == pair.full()["Results"]
        assert not any(t.startswith("pkg02") for t, _ in secret_targets(mine))

    def test_added_and_deleted_files(self, tmp_path, wd, dbs):
        root = make_tree(tmp_path)
        pair = Pair(root, dbs)
        pair.scan()
        (root / "pkg01" / "cred.txt").unlink()
        write(root, "pkg_new/cred.txt", f"fresh token {SAMPLES['github-pat']}\n")
        mine, stats = pair.scan(since_last=True)
        assert mine["Results"] == pair.full()["Results"]
        targets = {t for t, _ in secret_targets(mine)}
        assert "pkg_new/cred.txt" in targets and "pkg01/cred.txt" not in targets
        assert stats["units_analyzed"] == 2

    def test_plain_incremental_survives_touched_mtimes(self, tmp_path, wd, dbs):
        root = make_tree(tmp_path)
        pair = Pair(root, dbs)
        pair.scan()
        touch_all(root, 2 * 10**18)
        _, stats = pair.scan()
        assert (stats["units_analyzed"], stats["files_hashed"]) == (0, 8)

    def test_helm_chart_subtree_is_one_unit(self, tmp_path, wd, dbs):
        root = tmp_path / "tree"
        write(root, "chart/Chart.yaml", "name: c\nversion: 1.0.0\n")
        write(root, "chart/templates/d.yaml", "kind: Deployment\n")
        _, stats = Pair(root, dbs).scan()
        assert stats["units_total"] == 1

    def test_manifest_invalidated_by_secret_config_content(self, tmp_path, wd, dbs):
        root = make_tree(tmp_path, n_dirs=2)
        write(root, "pkg00/zz.txt", "x zzz_0123abcd y\n")
        cfg = tmp_path / "secret.yaml"
        cfg.write_text(RESTRICTED)
        pair = Pair(root, dbs, cfg=str(cfg))
        first, _ = pair.scan()
        assert "zzz-token" not in json.dumps(first)
        cfg.write_text(RESTRICTED + "rules:\n  - id: zzz-token\n    regex: zzz_[0-9a-f]{8}\n"
                       "    keywords: [zzz_]\n    severity: HIGH\n")
        mine, stats = pair.scan(since_last=True)
        assert stats["units_reused"] == 0
        assert "zzz-token" in {rid for _, rid in secret_targets(mine)}
        assert mine["Results"] == pair.full()["Results"]

    def test_incremental_blob_merge_is_deterministic(self, tmp_path, wd, dbs):
        pair = Pair(make_tree(tmp_path, rich=True), dbs)
        r1, s1 = pair.scan()
        r2, s2 = pair.scan()
        assert s1["unit_set"] == s2["unit_set"] and same(r1, r2)

    def test_secret_only_keys_differ_from_jax(self, tmp_path, wd, dbs):
        """A secret-only fs scan runs only the OS identity analyzers beside
        the secret one in the port, so its fingerprint and keys are not the
        JAX ones; its findings and reuse counts are."""
        root = make_tree(tmp_path)
        pair = Pair(root, dbs, scanners=("secret",), keys_equal=False)
        pair.scan()
        edit(root / "pkg03" / "data.py", f"k = '{SAMPLES['github-pat']}'\n", 10**18)
        mine, stats = pair.scan(since_last=True)
        assert stats["units_analyzed"] == 1 and ("pkg03/data.py", "github-pat") in \
            secret_targets(mine)

    def test_file_vanishing_before_its_hash_is_skipped(self, tmp_path, wd, dbs, monkeypatch):
        """A file that cannot be read when hashed is left out and counted as
        skipped, in both packages (``SkippedFiles``)."""
        from trivy_tpu.incremental import fs as jax_fs
        from trivy_tpu_torch.incremental import fs as port_fs

        root = make_tree(tmp_path)
        for mod in (port_fs, jax_fs):
            real = mod._hash_file
            monkeypatch.setattr(mod, "_hash_file", lambda p, real=real: (
                None if p.endswith("pkg01/data.py") else real(p)))
        mine, stats = Pair(root, dbs).scan()
        assert mine["Metadata"]["SkippedFiles"] == 1 and stats["files_skipped"] == 1
        assert (stats["files_hashed"], stats["files_walked"]) == (7, 8)


# -- the git diff scan (the JAX TestDiffBase) ------------------------------------


class TestDiffBase:
    def test_diff_base_parity_on_mutated_repo(self, tmp_path, wd, dbs):
        root = make_tree(tmp_path, rich=True)
        base = commit_all(root)
        pair = Pair(root, dbs)
        pair.scan()  # the manifest at the clean base commit
        edit(root / "pkg03" / "cred.txt", "rotated away\n", 10**18)
        write(root, "pkg00/extra.txt", f"new token {SAMPLES['github-pat']}\n")
        touch_all(root, 3 * 10**18)  # a fresh checkout: no mtime matches
        mine, stats = pair.scan(diff_base=base)
        assert mine["Results"] == pair.full()["Results"]
        assert stats["units_analyzed"] == 2
        assert (stats["files_git_reused"], stats["files_hashed"]) == (16, 2)

    def test_diff_base_after_a_commit_reuses_every_file(self, tmp_path, wd, dbs):
        """A scan at a commit, then every mtime touched: ``--diff-base
        HEAD`` keys every file from the manifest and analyzes no unit."""
        root = make_tree(tmp_path)
        commit_all(root)
        pair = Pair(root, dbs)
        first, _ = pair.scan(since_last=True)
        touch_all(root, 4 * 10**18)
        again, stats = pair.scan(diff_base="HEAD")
        assert same(again, first)
        assert (stats["files_git_reused"], stats["files_hashed"], stats["units_analyzed"]) == (
            8, 0, 0)

    def test_diff_base_bad_ref_is_loud(self, tmp_path, wd, dbs):
        root = make_tree(tmp_path, n_dirs=1)
        commit_all(root)
        with pytest.raises(manifest.GitDiffError):
            Pair(root, dbs).port(diff_base="no-such-ref")

    def test_diff_base_never_reuses_dirty_worktree_manifest(self, tmp_path, wd, dbs):
        root = make_tree(tmp_path, n_dirs=2)
        base = commit_all(root)
        with open(root / "pkg00" / "data.py", "a") as f:
            f.write(f"oops = '{SAMPLES['github-pat']}'\n")  # uncommitted secret
        pair = Pair(root, dbs)
        dirty, _ = pair.scan()  # the manifest of a dirty tree: no commit
        assert ("pkg00/data.py", "github-pat") in secret_targets(dirty)
        git(root, "checkout", "--", "pkg00/data.py")
        mine, stats = pair.scan(diff_base=base)
        assert stats["files_git_reused"] == 0
        assert ("pkg00/data.py", "github-pat") not in secret_targets(mine)
        assert mine["Results"] == pair.full()["Results"]

    def test_diff_base_in_a_subdirectory_of_the_repository(self, tmp_path, wd, dbs):
        """The CI call ``fs <subdir> --diff-base <commit>``: git names paths
        from the repository's top, the walker from the scan root. A commit
        that plants a secret under the root is seen, and a change outside
        the root is none of its files. (The JAX package compares the two
        namings as they stand and reuses the stale key.)"""
        repo = tmp_path / "repo"
        root = make_tree(repo / "services")
        write(repo, "README.txt", "top\n")
        base = commit_all(repo)
        assert manifest.git_changed_paths(str(root), base) == set()
        pair = Pair(root, dbs)
        pair.scan()  # the manifest at the clean base commit
        edit(root / "pkg01" / "data.py", f"key = '{SAMPLES['github-pat']}'\n", 10**18)
        write(repo, "README.txt", "edited\n")
        commit_all(repo, "plant")
        touch_all(root, 5 * 10**18)
        assert manifest.git_changed_paths(str(root), base) == {"pkg01/data.py"}
        mine, stats = pair.port(diff_base=base)
        assert ("pkg01/data.py", "github-pat") in secret_targets(mine)
        assert mine["Results"] == pair.full()["Results"]
        assert (stats["files_git_reused"], stats["files_hashed"], stats["units_analyzed"]) == (
            7, 1, 1)

    def test_diff_base_never_reuses_an_ignored_file(self, tmp_path, wd, dbs):
        """git keeps no record of an ignored file's content, so its key is
        never reused: secrets written into ignored files after the
        manifest's commit are found. A root inside an ignored directory is
        changed as a whole. (The JAX package reuses the stale keys.)"""
        root = make_tree(tmp_path, n_dirs=2)
        write(root, ".gitignore", "local.env\nbuild/\n")
        write(root, "local.env", "empty\n")
        write(root, "build/out.txt", "empty\n")
        base = commit_all(root)
        pair = Pair(root, dbs)
        pair.scan()
        assert manifest.git_changed_paths(str(root), base) == {"local.env", "build/"}
        assert manifest.git_changed_paths(str(root / "build"), base) == {""}
        edit(root / "local.env", f"TOKEN={SAMPLES['github-pat']}\n", 10**18)
        edit(root / "build" / "out.txt", f"t {SAMPLES['slack-access-token']}\n", 10**18)
        touch_all(root, 6 * 10**18)
        mine, stats = pair.port(diff_base=base)
        assert {("local.env", "github-pat"),
                ("build/out.txt", "slack-access-token")} <= secret_targets(mine)
        assert mine["Results"] == pair.full()["Results"]
        assert (stats["files_git_reused"], stats["files_hashed"]) == (5, 2)

    def test_diff_base_without_manifest_falls_back_to_hashing(self, tmp_path, wd, dbs):
        root = make_tree(tmp_path, n_dirs=2)
        commit_all(root)
        mine, stats = Pair(root, dbs).scan(diff_base="HEAD")
        assert (stats["files_git_reused"], stats["files_hashed"]) == (0, 4)


# -- the command line (the JAX TestWiring, and fs, rootfs, repo) -----------------


def run_both(wd: Path, command: str, target, *args: str) -> tuple[dict, dict, int, int]:
    """Both CLIs from ``wd``, each on its own cache directory: the port's
    JSON, the JAX package's (``{}`` when none was written) and both exit
    codes; the port's counters are in ``wd / "stats.json"``."""
    mine_out, ref_out, stats = wd / "port.json", wd / "jax.json", wd / "stats.json"
    for p in (mine_out, ref_out, stats):
        p.unlink(missing_ok=True)
    rc1 = cli.main([command, "--device", "cpu", "--format", "json", "-o", str(mine_out), "-q",
                    "--cache-dir", str(wd / "c1"), "--stats-out", str(stats), *args,
                    str(target)])
    rc2 = jax_cli.main([command, "--backend", "cpu", "--format", "json", "-o", str(ref_out),
                        "-q", "--cache-dir", str(wd / "c2"), *args, str(target)])
    return (json.loads(mine_out.read_text()) if mine_out.exists() else {},
            json.loads(ref_out.read_text()) if ref_out.exists() else {}, rc1, rc2)


@pytest.fixture
def jax_last_stats(monkeypatch):
    """The ``last_stats`` of every JAX incremental scan, in order."""
    seen = []
    real = JaxIncrementalFSArtifact.inspect

    def inspect(self):
        ref = real(self)
        seen.append(self.last_stats)
        return ref

    monkeypatch.setattr(JaxIncrementalFSArtifact, "inspect", inspect)
    return seen


@pytest.mark.parametrize("command", ["fs", "rootfs", "repo"])
def test_cli_steps_equal_jax(tmp_path, wd, dbs, jax_last_stats, command):
    """``--incremental`` cold, ``--since-last`` unchanged, one edit, then a
    commit, every mtime touched and ``--diff-base HEAD``: the port's report
    and reuse counts equal the JAX CLI's at each step, and its full scan."""
    root = make_tree(tmp_path, rich=True)
    commit_all(root)
    head = ["--scanners", "vuln,secret,license", "--db-repository", dbs["dir"]]
    # the manifest of the edit's scan has no commit (a dirty worktree): the
    # scan after the commit records one for --diff-base to trust
    steps = [(["--incremental"], None), (["--since-last"], None),
             (["--since-last"], lambda: edit(root / "pkg01" / "data.py",
                                             f"t = '{SAMPLES['github-pat']}'\n", 10**18)),
             (["--since-last"], lambda: commit_all(root, "edit")),
             (["--diff-base", "HEAD"], lambda: touch_all(root, 5 * 10**18))]
    want = [(11, 0, 0), (0, 17, 0), (1, 16, 0), (0, 17, 0), (0, 0, 17)]
    for (flags, change), (analyzed, stat_reused, git_reused) in zip(steps, want):
        if change is not None:
            change()
        mine, ref, rc1, rc2 = run_both(wd, command, root, *head, *flags)
        assert rc1 == rc2 == 0
        assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
        stats = json.loads((wd / "stats.json").read_text())
        assert {k: stats[k] for k in COUNTS} == {k: jax_last_stats[-1][k] for k in COUNTS}
        assert stats["unit_set"] == digest(jax_last_stats[-1]["unit_keys"])
        assert (stats["units_analyzed"], stats["files_stat_reused"],
                stats["files_git_reused"]) == (analyzed, stat_reused, git_reused)
    full, _ref, rc, _ = run_both(wd, command, root, *head)
    assert rc == 0 and full["Results"] == mine["Results"] and full["Metadata"] == mine["Metadata"]
    assert ("pkg01/data.py", "github-pat") in secret_targets(mine)


@pytest.mark.parametrize("ref", ["no-such-ref", "HEAD~3"])
def test_diff_base_bad_ref_clean_cli_error(tmp_path, wd, ref):
    """A ref git cannot resolve, or a tree that is no git worktree: exit 1
    and no report, in both CLIs."""
    root = make_tree(tmp_path, n_dirs=1)
    mine, theirs, rc1, rc2 = run_both(wd, "fs", root, "--diff-base", ref)
    assert rc1 == rc2 == 1 and mine == theirs == {}
    assert not (wd / "stats.json").exists()
    commit_all(root)
    mine, theirs, rc1, rc2 = run_both(wd, "fs", root, "--diff-base", ref)
    assert rc1 == rc2 == 1 and mine == theirs == {}


def test_incremental_off_never_imports_subsystem(tmp_path, wd):
    """A scan without an incremental flag imports nothing of
    ``trivy_tpu_torch.incremental`` and writes no manifest (in a fresh
    process); with ``--incremental`` it writes one."""
    root = make_tree(tmp_path, n_dirs=1)
    repo = Path(__file__).resolve().parent.parent

    def run(*extra: str) -> list:
        code = (
            "import sys\n"
            f"sys.path.insert(0, {str(repo)!r})\n"
            "from trivy_tpu_torch.cli import main\n"
            f"rc = main(['fs', '--device', 'cpu', '-q', '--format', 'json',\n"
            f"          '-o', {str(wd / 'out.json')!r}, '--cache-dir', {str(wd / 'c')!r},\n"
            f"          *{list(extra)!r}, {str(root)!r}])\n"
            "assert rc == 0, rc\n"
            "print(sorted(m for m in sys.modules if m.startswith('trivy_tpu_torch.incr')))\n"
        )
        out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                             text=True, cwd=wd, timeout=600).stdout
        adir = wd / "c" / "fanal" / "artifact"
        names = os.listdir(adir) if adir.is_dir() else []
        return [json.loads(out.strip().splitlines()[-1].replace("'", '"')),
                [n for n in names if n.startswith("incr-manifest")]]

    assert run() == [[], []]
    modules, manifests = run("--incremental")
    assert "trivy_tpu_torch.incremental.fs" in modules and len(manifests) == 1


def test_cli_incremental_flags_parse():
    p = cli.build_parser()
    ns = p.parse_args(["fs", "--incremental", "--since-last", "/x"])
    assert ns.incremental and ns.since_last
    ns = p.parse_args(["repo", "--diff-base", "HEAD~3", "/x"])
    assert ns.diff_base == "HEAD~3"
    ns = p.parse_args(["watch", "--watch-count", "3", "/x"])
    assert ns.watch_count == 3
    ns = p.parse_args(["rootfs", "--since-last", "/x"])
    assert ns.since_last


@pytest.mark.parametrize("source", ["cli", "env", "config"])
def test_incremental_flags_resolve_from_every_source(tmp_path, wd, dbs, monkeypatch, source):
    """``--since-last`` from the command line, ``TRIVY_TPU_SINCE_LAST`` and
    ``incremental.since-last``: the second scan reuses every file."""
    root = make_tree(tmp_path, n_dirs=2)
    args = ["--scanners", "secret"]
    if source == "cli":
        args.append("--since-last")
    elif source == "env":
        monkeypatch.setenv("TRIVY_TPU_SINCE_LAST", "true")
    else:
        (wd / "trivy-tpu.yaml").write_text("incremental:\n  since-last: true\n")
    for want in (0, 4):
        mine, ref, rc1, rc2 = run_both(wd, "fs", root, *args)
        assert rc1 == rc2 == 0 and mine["Results"] == ref["Results"]
        assert json.loads((wd / "stats.json").read_text())["files_stat_reused"] == want


def test_incremental_refused_with_server_and_fleet(tmp_path, wd, capsys):
    """With ``--server`` every incremental flag exits 2 with the JAX
    message, and so does ``--incremental`` with ``--fleet``."""
    root = make_tree(tmp_path, n_dirs=1)
    for flags in (["--incremental"], ["--since-last"], ["--diff-base", "HEAD"]):
        argv = ["fs", "--device", "cpu", "-q", "--server", "http://127.0.0.1:9", *flags,
                str(root)]
        assert cli.main(argv) == 2
        assert "require a local scan path (drop --server" in capsys.readouterr().err
        with pytest.raises(ValueError, match="local scan path"):
            cli.scan_fs(str(root), device="cpu", server="http://127.0.0.1:9",
                        incremental=IncrementalOptions(enabled=True))
    assert cli.main(["fs", "--device", "cpu", "--incremental", "--fleet", "h:1", str(root)]) == 2
    assert "do not compose with --fleet" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--incremental", "--since-last"])
def test_image_ignores_incremental_flags_with_a_warning(tmp_path, wd, capsys, flag):
    """The JAX ``image`` takes ``--incremental`` and ``--since-last`` and
    never reads them: the port scans as without them and warns once."""
    from tests.imagetest import docker_save_tar, tar_bytes

    image = docker_save_tar(tmp_path / "img.tar", [tar_bytes({
        "app/cred.txt": f"token {SAMPLES['github-pat']}\n".encode()})])
    outs = []
    for extra in ([], [flag]):
        out = wd / f"img{len(outs)}.json"
        assert cli.main(["image", "--device", "cpu", "--format", "json", "-o", str(out),
                         "--cache-dir", str(wd / f"ci{len(outs)}"), *extra, image]) == 0
        outs.append(json.loads(out.read_text()))
    err = capsys.readouterr().err
    assert outs[0]["Results"] == outs[1]["Results"]
    assert err.count(f"{flag} ignored by image") == 1
    assert jax_cli.main(["image", "--backend", "cpu", "--format", "json", "-q", "-o",
                         str(wd / "jax.json"), "--cache-dir", str(wd / "cj"), flag,
                         image]) == 0
    assert json.loads((wd / "jax.json").read_text())["Results"] == outs[1]["Results"]
