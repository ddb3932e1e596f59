"""``image --diff-base`` of the port against the JAX package's: the layers a
derived image shares with its base are analyzed from the base under the
derived image's keys, only the new layer from the target, and the report
equals a plain scan's. A base that cannot be read exits 1 with no report in
both CLIs. On ``fs``, ``rootfs`` and ``repo`` the flag is the git diff scan
from every source: a report equal to the JAX one on a git worktree, exit 1
and no report elsewhere."""

import json
import os
import subprocess
from pathlib import Path

import pytest

from tests.imagetest import docker_save_tar, tar_bytes
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu.artifact import image as jax_image
from trivy_tpu.artifact.local_fs import ArtifactOption
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu_torch import cli
from trivy_tpu_torch.artifact import image as port_image
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.fanal.scan import ScanAnalyzers

GHP = "ghp_" + "A" * 36
AWS = "AKIA" + "QWERTYUIOPASDFGH"
# the first layer is the base image's (an empty-layer CMD ends it): its
# secret scan is skipped, and its key says so
HISTORY = [
    {"created_by": "/bin/sh -c #(nop) ADD file:os in / "},
    {"created_by": '/bin/sh -c #(nop)  CMD ["/bin/sh"]', "empty_layer": True},
    {"created_by": "COPY base /base"},
    {"created_by": "COPY app /app"},
]


def build_images(tmp: Path) -> dict:
    """``base.tar`` (two layers, the first the base image's) and
    ``derived.tar`` (those two and a new one) under ``tmp``."""
    shared = [
        tar_bytes({"etc/alpine-release": b"3.18.4\n",
                   "lib/apk/db/installed": b"P:musl\nV:1.2.4-r1\nA:x86_64\n\n",
                   "etc/base.env": f"aws_access_key_id = {AWS}\n".encode()}),
        tar_bytes({"base/cred.txt": f"token {GHP}\n".encode() * 2}),
    ]
    new = tar_bytes({"app/cred.txt": f"app token {GHP}\n".encode(),
                     "app/package-lock.json": json.dumps({"lockfileVersion": 3, "packages": {
                         "node_modules/lodash": {"version": "4.17.15"}}}).encode()})
    return {
        "base": docker_save_tar(tmp / "base.tar", shared, history=HISTORY[:3],
                                repo_tag="base:1"),
        "derived": docker_save_tar(tmp / "derived.tar", shared + [new], history=HISTORY,
                                   repo_tag="derived:1"),
        "junk": str(tmp / "junk.tar"),
    }


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return build_images(tmp_path_factory.mktemp("diffbase"))


@pytest.fixture
def wd(tmp_path, monkeypatch, images):
    (tmp_path / "wd").mkdir()
    monkeypatch.chdir(tmp_path / "wd")
    with open(images["junk"], "wb") as f:
        f.write(b"not an image archive" * 100)
    return tmp_path / "wd"


def port_artifact(path: str, cache) -> port_image.ImageArchiveArtifact:
    return port_image.ImageArchiveArtifact(path, cache, ScanAnalyzers(["secret"], "cpu",
                                                                      packages=True))


def test_preseed_counts_equal_jax(images):
    port_cache, jax_cache = new_cache("memory"), jax_new_cache("memory")
    art = port_artifact(images["derived"], port_cache)
    jax_art = jax_image.ImageArchiveArtifact(images["derived"], jax_cache,
                                             ArtifactOption(backend="cpu"))
    want = {"shared": 2, "seeded": 2, "new": 1}
    assert port_image.preseed_from_base(art, images["base"]) == want
    assert jax_image.preseed_from_base(jax_art, images["base"], jax_cache,
                                       ArtifactOption(backend="cpu")) == want
    assert art.stats["layers_seeded"] == 2 and art.stats["files_walked"] == 4
    # the seeded keys are the derived plan's: a base layer's key carries the
    # secret skip the base image alone would not give it
    archive = art._open_source()
    plan = art.layer_plan(archive)
    archive.close()
    assert plan["base_layers"] == {0}
    assert port_cache.missing_blobs("", plan["layer_keys"])[1] == plan["layer_keys"][2:]
    # after the scan, a second preseed finds everything cached
    assert len(art.inspect().blob_ids) == 4 and art.stats["layers_analyzed"] == 1
    again = port_artifact(images["derived"], port_cache)
    assert port_image.preseed_from_base(again, images["base"]) == {
        "shared": 0, "seeded": 0, "new": 0}


def run_both(wd, target, *args) -> tuple[dict, dict, int, int]:
    mine_out, ref_out = wd / "port.json", wd / "jax.json"
    rc1 = cli.main(["image", "--device", "cpu", "--format", "json", "-o", str(mine_out), "-q",
                    "--cache-dir", str(wd / "c1"), "--stats-out", str(wd / "stats.json"), *args,
                    target])
    rc2 = jax_cli.main(["image", "--backend", "cpu", "--format", "json", "-o", str(ref_out),
                        "-q", "--cache-dir", str(wd / "c2"), *args, target])
    return (json.loads(mine_out.read_text()) if mine_out.exists() else {},
            json.loads(ref_out.read_text()) if ref_out.exists() else {}, rc1, rc2)


def test_diff_base_equals_jax_and_a_plain_scan(images, wd):
    args = ("--scanners", "vuln,secret", "--list-all-pkgs")
    mine, ref, rc1, rc2 = run_both(wd, images["derived"], "--diff-base", images["base"], *args)
    assert rc1 == rc2 == 0
    assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
    stats = json.loads((wd / "stats.json").read_text())
    assert (stats["layers_seeded"], stats["layers_analyzed"], stats["layers_cached"]) == (2, 1, 2)
    plain, _ = cli.scan_image(images["derived"], device="cpu", cache=new_cache("memory"),
                              scanners=("vuln", "secret"), list_all_pkgs=True)
    assert mine["Results"] == plain.to_dict()["Results"]
    secrets = {(r["Target"], s["RuleID"]) for r in mine["Results"] for s in r.get("Secrets", [])}
    # the base layer's secret stays skipped when it is seeded from the base
    assert secrets == {("/app/cred.txt", "github-pat"), ("/base/cred.txt", "github-pat")}


@pytest.mark.parametrize("base", ["junk", "unreachable"])
def test_unreadable_base_exits_1_with_no_report(images, wd, monkeypatch, base):
    """An archive that is no image, or a registry reference no registry
    serves: both CLIs log the error and exit 1, never a full scan."""
    if base == "junk":
        target, extra = images["junk"], []
    else:
        import socket

        s = socket.socket()
        s.bind(("localhost", 0))
        target, extra = f"localhost:{s.getsockname()[1]}/base:1", ["--image-src", "remote"]
        s.close()
    monkeypatch.delenv("DOCKER_HOST", raising=False)
    mine, ref, rc1, rc2 = run_both(wd, images["derived"], "--diff-base", target, *extra)
    assert rc1 == rc2 == 1
    assert mine == ref == {}
    assert not (wd / "stats.json").exists()


@pytest.mark.parametrize("source", ["cli", "env", "config"])
@pytest.mark.parametrize("command", ["fs", "rootfs", "repo"])
def test_diff_base_refused_off_image(images, wd, monkeypatch, source, command):
    """``--diff-base`` on a tree is the JAX git diff scan, from the command
    line, ``TRIVY_TPU_DIFF_BASE`` and ``incremental.diff-base`` alike: on a
    git worktree both CLIs scan and give the same report; on a tree that is
    no git worktree both exit 1 and write no report."""
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(wd.parent))
    tree = wd / "tree"
    tree.mkdir()
    (tree / "app.env").write_text(f"token = {GHP}\n")
    (wd / "trivy-secret.yaml").write_text("enable-builtin-rules: [github-pat]\n")
    extra = []
    if source == "cli":
        extra = ["--diff-base", "HEAD"]
    elif source == "env":
        monkeypatch.setenv("TRIVY_TPU_DIFF_BASE", "HEAD")
    else:
        (wd / "trivy-tpu.yaml").write_text("incremental:\n  diff-base: HEAD\n")

    def both() -> tuple[dict, dict, int, int]:
        mine_out, ref_out = wd / "port.json", wd / "jax.json"
        for p in (mine_out, ref_out):
            p.unlink(missing_ok=True)
        rc1 = cli.main([command, "--device", "cpu", "--format", "json", "-o", str(mine_out),
                        "-q", "--cache-dir", str(wd / "c1"), *extra, str(tree)])
        rc2 = jax_cli.main([command, "--backend", "cpu", "--format", "json", "-o",
                            str(ref_out), "-q", "--cache-dir", str(wd / "c2"), *extra,
                            str(tree)])
        return (json.loads(mine_out.read_text()) if mine_out.exists() else {},
                json.loads(ref_out.read_text()) if ref_out.exists() else {}, rc1, rc2)

    mine, ref, rc1, rc2 = both()
    assert rc1 == rc2 == 1 and mine == ref == {}
    git_env = {"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t", "GIT_COMMITTER_NAME": "t",
               "GIT_COMMITTER_EMAIL": "t@t", "GIT_CONFIG_GLOBAL": os.devnull,
               "GIT_CONFIG_NOSYSTEM": "1"}
    for args in (["init", "-q"], ["add", "-A"], ["commit", "-qm", "base"]):
        subprocess.run(["git", *args], cwd=tree, check=True, capture_output=True,
                       env={**os.environ, **git_env})
    mine, ref, rc1, rc2 = both()
    assert rc1 == rc2 == 0
    assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
    assert [(r["Target"], s["RuleID"]) for r in mine["Results"] for s in r["Secrets"]] == [
        ("app.env", "github-pat")]
