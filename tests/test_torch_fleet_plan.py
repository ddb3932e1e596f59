"""The port's shard planner (``trivy_tpu_torch/fleet/plan.py``) held against
the JAX planner (``trivy_tpu/fleet/plan.py``): on the same tree and the same
settings both plan the same shards, with equal ``Paths``, ``Bytes``, order
and every wire key, at 1, 2, 4 and 8 shards (with a Helm chart subtree and a
skipped directory); ``split_fs_shard`` of the same shard after a file was
deleted; ``plan_image_shards`` of an image with some layers already cached;
the shard's settings read back from the wire, and the shards a port
replica refuses (a scanner the port lacks, an unknown backend or kind) or
fails loudly (a secret config or a root this host cannot see).

The JAX side runs with an ``ArtifactOption(backend="cpu")`` (the JAX CLI's
for the image) and its ``ScanOptions``, the port's with
``ShardSettings(device="cpu")``; trees and images are small and fixed, so
equality is exact.
"""

import os
from pathlib import Path

import pytest

from tests.secret_samples import SAMPLES
from tests.test_fleet import make_image
from tests.test_torch_fs_vuln import make_tree, write
from trivy_tpu import commands as jax_commands
from trivy_tpu.artifact.image import ImageArchiveArtifact as JaxImageArchiveArtifact
from trivy_tpu.artifact.local_fs import ArtifactOption
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu.fleet import parse_fleet as jax_parse_fleet
from trivy_tpu.fleet import plan as jax_plan
from trivy_tpu.scanner import ScanOptions as JaxScanOptions
from trivy_tpu_torch.artifact.image import DaemonImageArtifact, ImageArchiveArtifact, ImageSourceOption
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.fanal.scan import ScanAnalyzers
from trivy_tpu_torch.fleet import FleetError, parse_fleet
from trivy_tpu_torch.fleet import plan

ALL = ["vuln", "secret", "license"]
RESTRICTED = "enable-builtin-rules:\n  - github-pat\n  - aws-access-key-id\n"


def wire_list(shards) -> list:
    return [(s.index, s.kind, s.nbytes, s.wire, s.blob_ids) for s in shards]


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> Path:
    """The fs-vuln tree of ``tests/test_torch_fs_vuln.py``, a Helm chart
    with a nested template directory, a skipped directory and a secret
    config file."""
    base = tmp_path_factory.mktemp("fleetplan")
    root = base / "tree"
    make_tree(root)
    write(root, "deploy/chart/Chart.yaml", b"apiVersion: v2\nname: c\nversion: 1.0.0\n")
    write(root, "deploy/chart/values.yaml", b"x: 1\n" * 300)
    write(root, "deploy/chart/templates/dep.yaml", b"kind: Deployment\n" * 100)
    write(root, "vendor/skipped.py", f"k = '{SAMPLES['github-pat']}'\n".encode() * 50)
    (base / "secret.yaml").write_text(RESTRICTED)
    return root


def both_settings(root: Path, scanners=ALL, **kw):
    """The JAX ``(ArtifactOption, ScanOptions)`` and the port's
    ``ShardSettings`` of one configuration."""
    cfg = str(root.parent / "secret.yaml")
    jopt = ArtifactOption(backend=kw.get("backend", "cpu"), secret_config_path=cfg,
                          skip_dirs=["vendor"], parallel=kw.get("parallel", 0))
    jso = JaxScanOptions(scanners=list(scanners), license_full=True)
    mine = plan.ShardSettings(scanners=list(scanners), license_full=True,
                              device="cpu" if kw.get("backend", "cpu") == "cpu" else "cuda",
                              secret_config=cfg, skip_dirs=["vendor"],
                              parallel=kw.get("parallel", 0))
    return (jopt, jso), mine


def test_parse_fleet_equals_jax():
    for value in ("a:1,b:2, a:1 ,", ["a:1", "b:2", "a:1"], None, "", " x "):
        assert parse_fleet(value) == jax_parse_fleet(value)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_fs_plan_equals_jax(tree, n_shards):
    (jopt, jso), mine = both_settings(tree)
    ref = jax_plan.plan_fs_shards(str(tree), jopt, jso, n_shards)
    got = plan.plan_fs_shards(str(tree), mine, n_shards)
    assert wire_list(got[0]) == wire_list(ref[0])
    assert got[1:] == ref[1:]
    assert got[0], "an empty plan proves nothing"
    paths = [p for s in got[0] for p in s.wire["Paths"]]
    assert len(paths) == got[2] == len(set(paths))
    assert not any(p.startswith("vendor/") for p in paths)
    owners = {s.index for s in got[0] for p in s.wire["Paths"] if p.startswith("deploy/chart/")}
    assert len(owners) == 1, "the Helm chart subtree was split"


@pytest.mark.parametrize("backend,parallel", [("cpu", 0), ("auto", 3)])
def test_analysis_wire_equals_jax(tree, backend, parallel):
    """``Backend`` is ``cpu`` for the CPU and ``auto`` for the card, as the
    JAX CLI's default backend is; the registry options ride as in JAX."""
    (jopt, jso), mine = both_settings(tree, backend=backend, parallel=parallel)
    assert plan._analysis_wire(mine) == jax_plan._analysis_wire(jopt, jso)
    jopt.insecure_registry, jopt.registry_username = True, "u"
    jopt.registry_password, jopt.platform = "p", "linux/amd64"
    mine.image_source = ImageSourceOption(insecure_registry=True, registry_username="u",
                                          registry_password="p", platform="linux/amd64")
    wire = plan._analysis_wire(mine)
    assert wire == jax_plan._analysis_wire(jopt, jso)
    assert wire["Registry"] == {"Insecure": True, "Username": "u", "Password": "p",
                                "Platform": "linux/amd64"}
    jopt.analyzer_extra = {"no_shared_arena": True}
    mine.shared_arena = False
    assert plan._analysis_wire(mine) == jax_plan._analysis_wire(jopt, jso)


@pytest.mark.parametrize("n", [2, 3])
def test_split_equals_jax_after_a_delete(tree, tmp_path, n):
    """A file deleted after the plan keeps its place at zero weight in both
    packages' fragments."""
    import shutil

    root = tmp_path / "tree"
    shutil.copytree(tree, root)
    shutil.copy(tree.parent / "secret.yaml", tmp_path / "secret.yaml")
    (jopt, jso), mine = both_settings(root)
    ref_shards, _, _ = jax_plan.plan_fs_shards(str(root), jopt, jso, 2)
    shards, _, _ = plan.plan_fs_shards(str(root), mine, 2)
    victim = shards[0].wire["Paths"][0]
    os.unlink(root / victim)
    ref = jax_plan.split_fs_shard(ref_shards[0], n)
    got = plan.split_fs_shard(shards[0], n)
    assert got is not None and wire_list(got) == wire_list(ref)
    assert sorted(p for f in got for p in f.wire["Paths"]) == shards[0].wire["Paths"]
    assert all(shards[0].index < f.index < shards[0].index + 1 for f in got)
    assert plan.split_fs_shard(shards[0], 1) is None
    one_unit = plan.ShardSpec(0, "fs", 1, wire={"Kind": "fs", "Root": str(root),
                                                "Paths": ["LICENSE"], "Bytes": 1})
    assert plan.split_fs_shard(one_unit) is None is jax_plan.split_fs_shard(one_unit)


def test_image_plan_equals_jax_with_cached_layers(tmp_path):
    """Two of six layers already cached on both sides: both plans leave
    them out and carry the same keys, weights, order and wire."""
    path = make_image(tmp_path, n_layers=6)
    scanners = ["vuln", "secret", "license"]
    jcache, cache = jax_new_cache("memory", None), new_cache("memory")
    # the JAX CLI's analyzer set for these scanners, whose layer keys are the port's
    jopt = jax_commands._artifact_option(None, {"backend": "cpu", "scanners": scanners,
                                               "license_full": True})
    jart = JaxImageArchiveArtifact(path, jcache, jopt)
    analyzers = ScanAnalyzers(scanners, "cpu", license_full=True, packages=True)
    art = ImageArchiveArtifact(path, cache, analyzers)
    jso = JaxScanOptions(scanners=scanners, license_full=True)
    mine = plan.ShardSettings(scanners=scanners, license_full=True, device="cpu")
    first = plan.plan_image_shards(art, cache, mine)
    assert wire_list(first.shards) == wire_list(jax_plan.plan_image_shards(jart, jcache, jso).shards)
    for s in first.shards[1:3]:
        jcache.put_blob(s.wire["BlobID"], {"SchemaVersion": 2})
        cache.put_blob(s.wire["BlobID"], {"SchemaVersion": 2})
    ref = jax_plan.plan_image_shards(jart, jcache, jso)
    got = plan.plan_image_shards(art, cache, mine)
    assert len(got.shards) == 4
    assert wire_list(got.shards) == wire_list(ref.shards)
    for attr in ("name", "artifact_key", "blob_ids", "config_key", "config_missing",
                 "image_metadata"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert [s.index for s in got.shards] == list(range(4))
    assert [s.nbytes for s in got.shards] == sorted((s.nbytes for s in got.shards), reverse=True)


def test_image_plan_refuses_a_daemon_export(tmp_path):
    art = object.__new__(DaemonImageArtifact)
    art.path = "alpine:3.18"
    with pytest.raises(FleetError, match="local daemon export"):
        plan.plan_image_shards(art, new_cache("memory"), plan.ShardSettings())


def test_shard_settings_read_the_wire_back(tree):
    (_jopt, _jso), mine = both_settings(tree, backend="auto", parallel=3)
    mine.image_source = ImageSourceOption(insecure_registry=True, registry_username="u",
                                          registry_password="p", platform="linux/arm64")
    shard = {"Kind": "fs", **plan._analysis_wire(mine), "WarmHits": [["k", {}]]}
    got = plan.shard_settings(shard, device="cuda:1")
    assert got.device == "cuda:1"
    assert (got.scanners, got.license_full, got.secret_config, got.skip_dirs, got.parallel) == (
        ALL, True, mine.secret_config, ["vendor"], 3)
    assert got.image_source == mine.image_source
    assert got.warm_hits == [["k", {}]]
    assert plan.shard_settings({**shard, "Backend": "cpu"}, device="cuda").device == "cpu"
    assert plan.shard_settings({"Kind": "image-layer"}).scanners == ["secret"]


@pytest.mark.parametrize("shard,match", [
    ({"Kind": "fs", "Scanners": ["secret", "rootkit"]}, "rootkit"),
    ({"Kind": "fs", "Backend": "tpu"}, "unknown backend 'tpu'"),
    ({"Kind": "nope"}, "unknown shard kind"),
    (["fs"], "JSON object"),
])
def test_unported_settings_are_refused(shard, match):
    with pytest.raises(plan.ShardRefused, match=match):
        plan.check_shard(shard)
    with pytest.raises(plan.ShardRefused, match=match):
        plan.execute_shard(shard, new_cache("memory"), device="cpu")


def test_missing_secret_config_and_root_fail_loudly(tree):
    with pytest.raises(FileNotFoundError, match="secret config"):
        plan.shard_settings({"Kind": "fs", "SecretConfig": "/nonexistent/rules.yaml"})
    with pytest.raises(FileNotFoundError, match="does not exist"):
        plan.execute_shard({"Kind": "fs", "Root": "/nonexistent/fleet/root",
                            "Paths": ["a.txt"], "Scanners": ["secret"]},
                           new_cache("memory"), device="cpu")
