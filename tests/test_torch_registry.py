"""The port's registry source against the JAX package's, on images served by
the in-process registry of ``tests/registrytest.py`` (the reference's
local-registry technique, pkg/fanal/test/integration): reference parsing,
the pull surface, digest checks, the bearer challenge, the platform pick of
an image index, the zstd refusal, and ``image <ref> --image-src remote``
through both CLIs (``Results`` and ``Metadata`` equal, exactly). The image
is ``test_torch_image.py``'s, pushed with its config, so a registry scan
also equals the archive's scan and reuses its cached layers."""

import gzip
import json
import socket
import tarfile

import pytest

from tests.imagetest import build_config, tar_bytes
from tests.registrytest import MemoryRegistry, digest_of, start_registry
from tests.test_torch_image import (  # noqa: F401
    ENV,
    HISTORY,
    assert_equal,
    env,
    few_torch_threads,
    wd,
)
from trivy_tpu import cli as jax_cli
from trivy_tpu.fanal import image_registry as jax_registry
from trivy_tpu_torch import cli
from trivy_tpu_torch.artifact.image import ImageSourceOption
from trivy_tpu_torch.fanal import image_registry as port_registry
from trivy_tpu_torch.fanal.image_registry import RegistryClient, RegistryError, RegistryImage

GHP = "ghp_" + "A" * 36
OCI_MANIFEST = "application/vnd.oci.image.manifest.v1+json"
OCI_INDEX = "application/vnd.oci.image.index.v1+json"
GZIP_LAYER = "application/vnd.oci.image.layer.v1.tar+gzip"


def push_image(reg: MemoryRegistry, repo: str, ref: str, layers: list[bytes], config: bytes,
               media_type: str = GZIP_LAYER) -> str:
    """An image manifest of ``layers`` (gzip-compressed for a gzip media
    type) and ``config`` under ``ref``; returns the manifest's digest."""
    descs = []
    for l in layers:
        stored = gzip.compress(l, compresslevel=1) if media_type.endswith("gzip") else l
        descs.append({"mediaType": media_type, "digest": reg.put_blob(repo, stored),
                      "size": len(stored)})
    manifest = {"schemaVersion": 2, "mediaType": OCI_MANIFEST,
                "config": {"mediaType": "application/vnd.oci.image.config.v1+json",
                           "digest": reg.put_blob(repo, config), "size": len(config)},
                "layers": descs}
    return reg.put_manifest(repo, ref, manifest, OCI_MANIFEST)


def push_index(reg: MemoryRegistry, repo: str, tag: str, by_platform: dict[str, str]) -> None:
    """An image index under ``tag``: ``os/arch`` -> manifest digest."""
    reg.put_manifest(repo, tag, {"schemaVersion": 2, "mediaType": OCI_INDEX, "manifests": [
        {"mediaType": OCI_MANIFEST, "digest": d,
         "platform": dict(zip(("os", "architecture"), p.split("/")))}
        for p, d in by_platform.items()]}, OCI_INDEX)


def small_layers() -> list[bytes]:
    return [tar_bytes({"etc/alpine-release": b"3.18.4\n",
                       "lib/apk/db/installed": b"P:musl\nV:1.2.4-r1\nA:x86_64\n\n"}),
            tar_bytes({"app/config.py": f"token = '{GHP}'\n".encode()})]


@pytest.fixture(scope="module")
def registry(env):
    """``localhost:<port>`` serving ``apps/web:v1`` (two small layers),
    ``apps/full:1`` (the fixture image behind a two-platform index, with
    its archive's config), ``apps/zstd:1`` and a corrupt blob; and a second
    registry behind bearer-token auth."""
    reg = MemoryRegistry()
    layers = small_layers()
    push_image(reg, "apps/web", "v1", layers,
               build_config([digest_of(l) for l in layers], env=["API_KEY=plain"]))
    full = env["layers"]
    amd64 = push_image(reg, "apps/full", "amd64",
                       full, build_config([digest_of(l) for l in full], HISTORY, ENV))
    arm64 = push_image(reg, "apps/full", "arm64", layers[:1],
                       build_config([digest_of(layers[0])]))
    push_index(reg, "apps/full", "1", {"linux/amd64": amd64, "linux/arm64": arm64})
    push_image(reg, "apps/zstd", "1", layers, build_config([digest_of(l) for l in layers]),
               media_type="application/vnd.oci.image.layer.v1.tar+zstd")
    # a blob and a manifest served under digests their bytes do not have
    blobs = reg.repos["apps/web"]["blobs"]
    blobs["sha256:" + "1" * 64] = b"not the bytes of that digest"
    reg.repos["apps/web"]["manifests"]["sha256:" + "2" * 64] = (b"{}", OCI_MANIFEST)
    auth = MemoryRegistry(token="s3cret-token")
    push_image(auth, "private/app", "latest", layers[1:],
               build_config([digest_of(layers[1])]))
    server, host = start_registry(reg)
    auth_server, auth_host = start_registry(auth)
    yield {"host": host, "auth": auth_host, "layers": layers}
    server.shutdown()
    auth_server.shutdown()


@pytest.fixture
def no_daemons(monkeypatch):
    """No docker, podman or containerd socket, in either package."""
    from trivy_tpu.fanal import image_daemon as jax_daemon
    from trivy_tpu_torch.fanal import image_daemon as port_daemon

    monkeypatch.delenv("DOCKER_HOST", raising=False)
    for mod in (jax_daemon, port_daemon):
        for name in ("DOCKER_SOCKETS", "PODMAN_SOCKETS", "CONTAINERD_SOCKETS"):
            monkeypatch.setattr(mod, name, [])


REFS = [
    ("localhost:5000/app:v1", ("localhost:5000", "app", "v1")),
    ("registry.example.com/team/app", ("registry.example.com", "team/app", "latest")),
    ("alpine:3.18", ("registry-1.docker.io", "library/alpine", "3.18")),
    ("alpine", ("registry-1.docker.io", "library/alpine", "latest")),
    ("team/app:1", ("registry-1.docker.io", "team/app", "1")),
    ("docker.io/alpine:3", ("registry-1.docker.io", "library/alpine", "3")),
    ("localhost/app", ("localhost", "app", "latest")),
    ("localhost:5000/app@sha256:" + "a" * 64, ("localhost:5000", "app", "sha256:" + "a" * 64)),
    ("localhost:5000/app:v1@sha256:" + "b" * 64, ("localhost:5000", "app", "sha256:" + "b" * 64)),
]


@pytest.mark.parametrize("ref,want", REFS, ids=[r for r, _ in REFS])
def test_parse_image_ref(ref, want):
    assert port_registry.parse_image_ref(ref) == jax_registry.parse_image_ref(ref) == want


def test_pull_image_surface(registry):
    ref = f"{registry['host']}/apps/web:v1"
    img = RegistryImage(ref, insecure=True)
    ref_img = jax_registry.RegistryImage(ref, insecure=True)
    assert img.image_id == ref_img.image_id and img.image_id.startswith("sha256:")
    assert img.diff_ids == ref_img.diff_ids == [digest_of(l) for l in registry["layers"]]
    assert img.layer_history() == ref_img.layer_history()
    for i, raw in enumerate(registry["layers"]):
        with img.layer_stream(i) as stream:
            assert stream.read() == raw
        assert stream.closed and stream._spool.closed  # the spool is freed
        assert img.layer_size(i) == len(gzip.compress(raw, compresslevel=1))
    with img.layer_stream(1) as stream, tarfile.open(fileobj=stream) as tf:
        assert tf.getnames() == ["app/config.py"]


def test_digest_mismatch_and_missing_blob(registry):
    for mod in (port_registry, jax_registry):
        client = mod.RegistryClient(registry["host"], insecure=True)
        with pytest.raises(mod.RegistryError, match="returned 404"):
            client.blob("apps/web", "sha256:" + "0" * 64)
        with pytest.raises(mod.RegistryError, match="blob digest mismatch"):
            client.blob("apps/web", "sha256:" + "1" * 64)
        with pytest.raises(mod.RegistryError, match="blob digest mismatch"):
            client.blob_file("apps/web", "sha256:" + "1" * 64)
        with pytest.raises(mod.RegistryError, match="manifest digest mismatch"):
            client.manifest("apps/web", "sha256:" + "2" * 64)
        good = client.manifest("apps/web", "v1")["layers"][0]["digest"]
        assert client.blob("apps/web", good)


def test_token_auth_challenge(registry):
    img = RegistryImage(f"{registry['auth']}/private/app:latest", insecure=True)
    assert img.diff_ids == [digest_of(registry["layers"][1])]
    assert img.client._token == "s3cret-token"  # went through 401 -> token -> retry
    client = RegistryClient(registry["auth"], insecure=True)
    client._token = "stale"  # a rejected token is replaced once
    assert client.manifest("private/app", "latest")["layers"]
    assert client._token == "s3cret-token"


@pytest.mark.parametrize("platform,layers", [("", 4), ("linux/amd64", 4), ("linux/arm64", 1),
                                             ("linux", 4)])
def test_platform_pick(registry, platform, layers):
    ref = f"{registry['host']}/apps/full:1"
    img = RegistryImage(ref, insecure=True, platform=platform)
    assert len(img.diff_ids) == layers
    assert img.image_id == jax_registry.RegistryImage(ref, insecure=True,
                                                      platform=platform).image_id


def test_platform_missing_lists_the_available(registry):
    ref = f"{registry['host']}/apps/full:1"
    errors = []
    for mod in (port_registry, jax_registry):
        with pytest.raises(mod.RegistryError) as exc:
            mod.RegistryImage(ref, insecure=True, platform="windows/amd64")
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert "available: linux/amd64, linux/arm64" in errors[0]


def test_zstd_layer_refused(registry, wd, no_daemons):
    img = RegistryImage(f"{registry['host']}/apps/zstd:1", insecure=True)
    with pytest.raises(RegistryError, match="zstd"):
        img.layer_stream(0)
    out = wd / "port.json"
    rc = cli.main(["image", "--device", "cpu", "-q", "--insecure", "--image-src", "remote",
                   "--cache-dir", str(wd / "c1"), "-o", str(out),
                   f"{registry['host']}/apps/zstd:1"])
    assert rc == 1 and not out.exists()
    with pytest.raises(jax_registry.RegistryError, match="zstd"):
        jax_cli.main(["image", "--backend", "cpu", "-q", "--insecure", "--image-src", "remote",
                      "--cache-dir", str(wd / "c2"), f"{registry['host']}/apps/zstd:1"])


def run_both(wd, target, *args) -> tuple[dict, dict]:
    """Both CLIs' ``image`` of ``target`` from ``wd`` (each its own cache)."""
    mine_out, ref_out = wd / "port.json", wd / "jax.json"
    assert cli.main(["image", "--device", "cpu", "--format", "json", "-o", str(mine_out), "-q",
                     "--cache-dir", str(wd / "c1"), *args, target]) == 0
    assert jax_cli.main(["image", "--backend", "cpu", "--format", "json", "-o", str(ref_out),
                         "-q", "--cache-dir", str(wd / "c2"), *args, target]) == 0
    return json.loads(mine_out.read_text()), json.loads(ref_out.read_text())


@pytest.mark.parametrize("scanners,extra", [("vuln,secret,license", ["--license-full"]),
                                            ("secret", ["--platform", "linux/amd64"])])
def test_registry_scan_equals_jax(registry, env, wd, no_daemons, scanners, extra):
    ref = f"{registry['host']}/apps/full:1"
    mine, jax = run_both(wd, ref, "--image-src", "remote", "--insecure", "--scanners", scanners,
                         "--db-repository", env["db"], *extra)
    assert_equal(mine, jax)
    assert mine["ArtifactName"] == ref and mine["ArtifactType"] == "container_image"
    assert len(mine["Metadata"]["DiffIDs"]) == 4
    targets = {r["Target"] for r in mine["Results"] if r["Class"] == "secret"}
    assert targets == {"/src/config.py", "container image config (env)"}


def test_registry_scan_equals_the_archive_and_reuses_its_layers(registry, env, wd, no_daemons):
    """The pulled image gives the archive's report (its name and the OS
    section's target aside), and after the archive's scan on one cache the
    pull analyzes no layer: the layer keys are diff-ID keys."""
    kw = dict(device="cpu", cache_dir=str(wd / "c"), scanners=("vuln", "secret", "license"),
              license_full=True, db_repository=env["db"])
    archive, s1 = cli.scan_image(env["docker"], **kw)
    ref = f"{registry['host']}/apps/full:1"
    src = ImageSourceOption(image_src=["remote"], insecure_registry=True)
    pulled, s2 = cli.scan_image(ref, image_source=src, **kw)
    assert (s1["layers_analyzed"], s2["layers_analyzed"], s2["layers_cached"]) == (4, 0, 4)
    assert s2["layer_bytes"] == 0 and s2["batches"] == 0
    fresh, s3 = cli.scan_image(ref, image_source=src, **{**kw, "cache_dir": str(wd / "c3")})
    assert s3["layers_analyzed"] == 4
    # stored bytes are the registry's gzip bytes
    assert s3["layer_bytes"] == sum(len(gzip.compress(l, compresslevel=1))
                                    for l in env["layers"])
    a, p, f = archive.to_dict(), pulled.to_dict(), fresh.to_dict()
    assert p["Results"] == f["Results"] and p["Metadata"] == f["Metadata"]
    assert json.loads(json.dumps(p["Results"]).replace(ref, a["ArtifactName"])) == a["Results"]
    assert p["Metadata"] == a["Metadata"]


def test_unreachable_registry_exits_1_with_no_report(wd, no_daemons):
    """``--image-src remote --insecure`` on a localhost port nothing serves:
    the JAX CLI raises (exit code 1) and writes nothing; the port exits 1,
    writes nothing."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        ref = f"localhost:{s.getsockname()[1]}/app:latest"
    args = ["-q", "--image-src", "remote", "--insecure"]
    out = wd / "port.json"
    rc = cli.main(["image", "--device", "cpu", *args, "-o", str(out), "--cache-dir",
                   str(wd / "c1"), ref])
    assert rc == 1 and not out.exists()
    ref_out = wd / "jax.json"
    with pytest.raises(jax_registry.RegistryError, match="cannot reach registry"):
        jax_cli.main(["image", "--backend", "cpu", *args, "-o", str(ref_out), "--cache-dir",
                      str(wd / "c2"), ref])
    assert not ref_out.exists()
