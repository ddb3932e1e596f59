"""``image`` and ``rootfs`` of the port against the JAX package's CLI, both run
in-process in one fresh working directory, on images built by
``tests/imagetest.py`` from ``test_torch_fs_vuln.make_tree``'s contents split
into layers: a base layer (the OS root, a secret that must not be reported,
a license file), the lockfiles and sources, a layer of whiteouts (a file
with a secret, a lockfile with a vulnerable package, and an opaque ``py/``),
and a small top layer that overwrites a license file. The config carries an
ENV secret and pinned ``apk add`` history. ``Results`` and ``Metadata`` must
be equal, exactly, as in ``test_torch_fs_vuln.py``."""

import io
import json
import os
import socket
import tarfile
from pathlib import Path

import pytest

from tests.dbtest import build_db
from tests.imagetest import docker_save_tar, oci_layout_dir
from tests.secret_samples import SAMPLES
from tests.test_torch_fs_vuln import make_tree
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu import commands as jax_commands
from trivy_tpu.artifact import image as jax_image
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu_torch import cli
from trivy_tpu_torch.artifact import image as port_image
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.cache.key import calc_key
from trivy_tpu_torch.fanal.scan import ScanAnalyzers
from trivy_tpu_torch.secret.scanner import TorchSecretScanner

GH, AWS = SAMPLES["github-pat"], SAMPLES["aws-access-key-id"]
MIT = (b"MIT License\n\nPermission is hereby granted, free of charge, to any person "
       b"obtaining a copy of this software.\n")
HISTORY = [
    {"created_by": "/bin/sh -c #(nop) ADD file:4f1 in / "},
    {"created_by": '/bin/sh -c #(nop)  CMD ["/bin/sh"]', "empty_layer": True},
    {"created_by": "/bin/sh -c apk add --no-cache musl=1.2.3-r0 busybox=1.36.0-r0 curl"},
    {"created_by": "/bin/sh -c rm -rf /app/secret.env /web/legacy /py"},
    {"created_by": "COPY motd /etc/motd # buildkit"},
]
ENV = ["PATH=/usr/bin", f"GITHUB_TOKEN={GH}"]
BASE_ONLY = ("etc/alpine-release", "lib/apk/db/installed")


def layer(files: dict[str, bytes], modes: dict[str, int] | None = None) -> bytes:
    """An uncompressed layer tar of ``files``, with their modes."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, content in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(content)
            info.mode = (modes or {}).get(name, 0o644)
            tf.addfile(info, io.BytesIO(content))
    return buf.getvalue()


def read_tree(root: Path) -> tuple[dict[str, bytes], dict[str, int]]:
    files, modes = {}, {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = p.relative_to(root).as_posix()
            files[rel], modes[rel] = p.read_bytes(), p.stat().st_mode & 0o777
    return files, modes


def image_layers(tree: Path, apk_db: bool = True) -> list[bytes]:
    files, modes = read_tree(tree)
    base = {k: files.pop(k) for k in BASE_ONLY}
    if not apk_db:
        del base["lib/apk/db/installed"]
    base["etc/base-creds.txt"] = f"aws_access_key_id = {AWS}\n".encode()
    base["opt/base/LICENSE"] = MIT
    files["app/secret.env"] = f"AWS_KEY={AWS}\n".encode()
    files["py/settings.py"] = f"TOKEN = '{GH}'\n".encode()
    files["deps/LICENSE"] = MIT
    whiteouts = {"app/.wh.secret.env": b"", "web/legacy/.wh.package-lock.json": b"",
                 "py/.wh..wh..opq": b""}
    top = {"deps/LICENSE": b"Release notes for the dependency bundle, nothing else.\n",
           "etc/motd": b"welcome to the fixture image\n"}
    return [layer(base), layer(files, modes), layer(whiteouts), layer(top)]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("image")
    make_tree(base / "tree")
    layers = image_layers(base / "tree")
    out = {"tree": base / "tree", "db": build_db(base), "layers": layers}
    out["docker"] = docker_save_tar(base / "img.tar", layers, history=HISTORY, env=ENV)
    out["oci-dir"] = oci_layout_dir(base / "oci", layers, history=HISTORY, env=ENV)
    with tarfile.open(base / "oci.tar", "w") as tf:
        tf.add(out["oci-dir"], arcname=".")
    out["oci-tar"] = str(base / "oci.tar")
    out["no-apk-db"] = docker_save_tar(base / "noapk.tar", image_layers(base / "tree", False),
                                       history=HISTORY, env=ENV)
    return out


@pytest.fixture
def wd(tmp_path, monkeypatch):
    d = tmp_path / "wd"
    d.mkdir()
    monkeypatch.chdir(d)
    return d


def run_both(wd: Path, command: str, target, *args) -> tuple[dict, dict, int, int]:
    """Both CLIs' ``command`` on ``target`` from ``wd``: the port's JSON, the
    JAX package's and both exit codes."""
    mine_out, ref_out = wd / "port.json", wd / "jax.json"
    rc_mine = cli.main([command, "--device", "cpu", "--format", "json", "-o", str(mine_out),
                        "-q", "--cache-dir", str(wd / "c1"), *args, str(target)])
    rc_ref = jax_cli.main([command, "--backend", "cpu", "--format", "json", "-o", str(ref_out),
                           "-q", "--cache-dir", str(wd / "c2"), *args, str(target)])
    return json.loads(mine_out.read_text()), json.loads(ref_out.read_text()), rc_mine, rc_ref


def assert_equal(mine, ref):
    assert mine["Results"] == ref["Results"]
    assert mine["Metadata"] == ref["Metadata"]
    assert (mine["ArtifactName"], mine["ArtifactType"]) == (ref["ArtifactName"],
                                                            ref["ArtifactType"])


def targets(report, cls=None) -> set:
    return {r["Target"] for r in report["Results"] if cls is None or r["Class"] == cls}


def vuln_ids(report) -> set:
    return {(r["Target"], v["VulnerabilityID"]) for r in report["Results"]
            for v in r.get("Vulnerabilities", [])}


SCANNER_SETS = [("vuln", []), ("secret", []), ("license", []),
                ("vuln,secret,license", ["--license-full"])]
CASES = [(s, e + l) for s, e in SCANNER_SETS for l in ([], ["--list-all-pkgs"])]


@pytest.mark.parametrize("scanners,extra", CASES, ids=[s + "".join(e) for s, e in CASES])
def test_image_equals_jax(env, wd, scanners, extra):
    mine, ref, rc1, rc2 = run_both(wd, "image", env["docker"], "--scanners", scanners,
                                   "--db-repository", env["db"], *extra)
    assert rc1 == rc2 == 0
    assert_equal(mine, ref)
    assert mine["ArtifactName"] == "fixture:latest"
    assert mine["ArtifactType"] == "container_image"
    assert mine["Metadata"]["OS"]["Family"] == "alpine"
    assert len(mine["Metadata"]["DiffIDs"]) == 4 and mine["Metadata"]["ImageConfig"]
    if "secret" in scanners:
        # the base layer's secret, the whited-out file and the opaque dir's
        # file are gone; the ENV secret and the source secret stay
        assert targets(mine, "secret") == {"/src/config.py", "container image config (env)"}
    if "vuln" in scanners:
        found = vuln_ids(mine)
        assert ("web/package-lock.json", "CVE-2021-23337") in found
        assert not any(t.startswith(("py/", "web/legacy/")) for t, _ in found)
    if "license" in scanners:
        lic = [r for r in mine["Results"] if r["Class"] == "license-file"]
        paths = {d["FilePath"] for r in lic for d in r["Licenses"]}
        # the base layer's license file is classified without a feed; the
        # top layer's notes overwrite deps/LICENSE but classify as nothing,
        # so the lower layer's finding stays, as in the applier's merge
        assert {"LICENSE", "opt/base/LICENSE", "deps/LICENSE"} <= paths


@pytest.fixture(scope="module")
def docker_full(env) -> dict:
    """The port's report of the docker-save image, every scanner on."""
    report, _ = cli.scan_image(env["docker"], device="cpu", cache=new_cache("memory"),
                               scanners=("vuln", "secret", "license"), license_full=True,
                               db_repository=env["db"])
    return report.to_dict()


@pytest.mark.parametrize("layout", ["oci-dir", "oci-tar"])
def test_oci_layouts_equal_jax_and_docker_save(env, wd, docker_full, layout):
    args = ("--scanners", "vuln,secret,license", "--license-full", "--db-repository", env["db"])
    mine, ref, rc1, rc2 = run_both(wd, "image", env[layout], *args)
    assert rc1 == rc2 == 0
    assert_equal(mine, ref)
    docker = docker_full
    name = mine["ArtifactName"]
    assert name == os.path.basename(env[layout])
    # the OS section's target names the artifact; everything else is equal
    for r in mine["Results"]:
        r["Target"] = r["Target"].replace(name, docker["ArtifactName"])
    assert mine["Results"] == docker["Results"]
    assert mine["Metadata"]["DiffIDs"] == docker["Metadata"]["DiffIDs"]


@pytest.mark.parametrize("apk_db", [True, False], ids=["apk-db", "history-only"])
def test_apk_history_equals_jax(env, wd, apk_db):
    target = env["docker"] if apk_db else env["no-apk-db"]
    mine, ref, _rc1, _rc2 = run_both(wd, "image", target, "--scanners", "vuln",
                                     "--db-repository", env["db"], "--list-all-pkgs")
    assert_equal(mine, ref)
    os_pkgs = [r for r in mine["Results"] if r["Class"] == "os-pkgs"]
    versions = {(p["Name"], p["Version"]) for p in os_pkgs[0]["Packages"]}
    # the pinned history packages stand in only where the apk DB is gone
    assert (("musl", "1.2.3-r0") in versions) != apk_db
    assert ("musl", "1.2.4-r2") in versions if apk_db else len(versions) == 2
    ids = {v for _t, v in vuln_ids(mine)}
    assert ("CVE-2023-0001" in ids) != apk_db


def test_layer_cache_reuse(env, wd):
    """A second scan with the same cache analyzes no layer, feeds no row and
    gives the same report; the JAX package's second scan agrees."""
    kw = dict(device="cpu", cache_dir=str(wd / "c1"), scanners=("vuln", "secret", "license"),
              license_full=True, db_repository=env["db"])
    first, s1 = cli.scan_image(env["docker"], **kw)
    second, s2 = cli.scan_image(env["docker"], **kw)
    assert (s1["layers"], s1["layers_analyzed"], s1["layers_cached"]) == (4, 4, 0)
    assert (s2["layers"], s2["layers_analyzed"], s2["layers_cached"]) == (4, 0, 4)
    assert s1["layer_bytes"] == sum(len(l) for l in env["layers"]) and s2["layer_bytes"] == 0
    assert s1["batches"] > 0 and s2["batches"] == 0 and s2["files_walked"] == 0
    assert first.to_dict()["Results"] == second.to_dict()["Results"]
    assert first.to_dict()["Metadata"] == second.to_dict()["Metadata"]
    out = wd / "jax.json"
    for _ in range(2):
        assert jax_cli.main(["image", "--backend", "cpu", "--format", "json", "-o", str(out),
                             "-q", "--cache-dir", str(wd / "c2"), "--scanners",
                             "vuln,secret,license", "--license-full", "--db-repository",
                             env["db"], env["docker"]]) == 0
    ref = json.loads(out.read_text())
    assert second.to_dict()["Results"] == ref["Results"]
    assert second.to_dict()["Metadata"] == ref["Metadata"]


# scanner options whose layer keys are compared with the JAX package's
KEY_OPTIONS = [
    {"scanners": ["secret"]}, {"scanners": ["vuln"]}, {"scanners": ["vuln", "secret"]},
    {"scanners": ["license"]}, {"scanners": ["license"], "license_full": True},
    {"scanners": ["secret", "license"], "license_full": True},
    {"scanners": ["secret"], "skip_dirs": ["web"]}, {"scanners": ["secret"], "skip_files": ["x"]},
]


def port_plan(path: str, o: dict) -> dict:
    an = ScanAnalyzers(o["scanners"], "cpu", license_full=o.get("license_full", False),
                       packages=True)
    art = port_image.ImageArchiveArtifact(path, new_cache("memory"), an,
                                          skip_files=o.get("skip_files", ()),
                                          skip_dirs=o.get("skip_dirs", ()))
    archive = port_image._ImageArchive(path)
    try:
        return art.layer_plan(archive)
    finally:
        archive.close()


def jax_plan(path: str, o: dict) -> dict:
    opt = jax_commands._artifact_option(None, {"backend": "cpu", **o})
    art = jax_image.ImageArchiveArtifact(path, jax_new_cache("memory"), opt)
    archive = art._open_source()
    try:
        return art.layer_plan(archive)
    finally:
        archive.close()


def test_layer_keys_change_with_the_jax_keys(env):
    """Across scanner sets, ``--license-full`` and the skip options, two
    scans share a layer key exactly when the JAX package's do; a base layer
    is keyed apart (``/secret-skipped``), and every key is the JAX
    recipe's."""
    port = [port_plan(env["docker"], o) for o in KEY_OPTIONS]
    ref = [jax_plan(env["docker"], o) for o in KEY_OPTIONS]
    assert port[0]["base_layers"] == ref[0]["base_layers"] == {0}
    for i in range(len(KEY_OPTIONS)):
        for j in range(len(KEY_OPTIONS)):
            for key in ("layer_keys", "config_key", "artifact_key"):
                assert (port[i][key] == port[j][key]) == (ref[i][key] == ref[j][key]), (i, j, key)
    an = ScanAnalyzers(["secret"], "cpu", packages=True)
    versions = an.versions()
    assert versions["secret"] == 1 and "license-file" not in versions
    diff0 = port[0]["diff_ids"][0]
    assert port[0]["layer_keys"][0] == calc_key(
        diff0 + "/secret-skipped", analyzer_versions=versions,
        hook_versions={"system-file-filter": 1})


@pytest.mark.parametrize("cut", ["header", "data"])
def test_truncated_layer_equals_jax(env, wd, cut):
    """A layer cut inside a tar header ends the layer's walk early in both
    packages (no ``SkippedFiles``); cut inside a file's data, the read fails
    and both scans fail."""
    full = layer({"notes/a.txt": b"hello world " * 100, "notes/b.txt": f"k={GH}\n".encode()})
    # 512-byte header, 1200 bytes padded to 1536, then b.txt's header
    at = 2048 + 200 if cut == "header" else 512 + 600
    path = docker_save_tar(wd / "cut.tar", [env["layers"][0], full[:at]])
    if cut == "data":
        with pytest.raises(tarfile.ReadError):
            cli.main(["image", "--device", "cpu", "-q", "--cache-dir", str(wd / "c1"), path])
        with pytest.raises(tarfile.ReadError):
            jax_cli.main(["image", "--backend", "cpu", "-q", "--cache-dir", str(wd / "c2"), path])
        return
    mine, ref, rc1, rc2 = run_both(wd, "image", path, "--scanners", "secret")
    assert rc1 == rc2 == 0
    assert_equal(mine, ref)
    assert "SkippedFiles" not in mine["Metadata"]


def test_fs_skipped_files_equal_jax(env, wd, monkeypatch):
    """A file that vanishes between the walk and the read is skipped and
    counted in ``Metadata.SkippedFiles`` by both packages."""
    from trivy_tpu.fanal import walker as jax_walker
    from trivy_tpu_torch.fanal import walker as port_walker

    tree = wd / "tree"
    for rel, text in (("a/gh.txt", f"token {GH} end\n"), ("a/victim.txt", "vanishing text\n")):
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_text(text)
    for mod in (jax_walker, port_walker):
        real = mod.FSWalker.walk

        def walk(self, root, _real=real):
            for rel, info, opener in _real(self, root):
                if rel == "a/victim.txt":
                    (Path(root) / rel).unlink()
                yield rel, info, opener

        monkeypatch.setattr(mod.FSWalker, "walk", walk)
    mine_out, ref_out = wd / "port.json", wd / "jax.json"
    assert cli.main(["fs", "--device", "cpu", "--format", "json", "-o", str(mine_out), "-q",
                     str(tree)]) == 0
    (tree / "a/victim.txt").write_text("vanishing text\n")
    assert jax_cli.main(["fs", "--backend", "cpu", "--format", "json", "-o", str(ref_out), "-q",
                         "--cache-dir", str(wd / "c2"), str(tree)]) == 0
    mine, ref = json.loads(mine_out.read_text()), json.loads(ref_out.read_text())
    assert mine["Metadata"]["SkippedFiles"] == ref["Metadata"]["SkippedFiles"] == 1
    assert mine["Results"] == ref["Results"] and targets(mine) == {"a/gh.txt"}


def test_parallel_one_equals_default(env, wd):
    kw = dict(device="cpu", scanners=("vuln", "secret", "license"), license_full=True,
              db_repository=env["db"])
    serial, s1 = cli.scan_image(env["docker"], cache=new_cache("memory"), parallel=1, **kw)
    parallel, s5 = cli.scan_image(env["docker"], cache=new_cache("memory"), **kw)
    assert serial.to_dict()["Results"] == parallel.to_dict()["Results"]
    assert serial.to_dict()["Metadata"] == parallel.to_dict()["Metadata"]
    for key in ("layers_analyzed", "files_walked", "files_scanned", "components"):
        assert s1[key] == s5[key]


@pytest.mark.parametrize("scanners", ["vuln,secret", "secret,license"])
def test_rootfs_equals_jax(env, wd, scanners):
    mine, ref, rc1, rc2 = run_both(wd, "rootfs", env["tree"], "--scanners", scanners,
                                   "--db-repository", env["db"])
    assert rc1 == rc2 == 0
    assert_equal(mine, ref)
    assert mine["ArtifactType"] == "filesystem" and mine["Results"]


def test_registry_target_refused(wd, monkeypatch, capsys):
    """A target that is no path, that no daemon holds and that no registry
    serves (a closed localhost port), under the default ``--image-src``:
    the JAX CLI raises (exit code 1 from the shell) and writes no report;
    the port logs the error, exits 1 and writes none."""
    from trivy_tpu.fanal import image_daemon as jax_daemon
    from trivy_tpu.fanal.image_registry import RegistryError
    from trivy_tpu_torch.fanal import image_daemon as port_daemon

    monkeypatch.delenv("DOCKER_HOST", raising=False)
    for mod in (jax_daemon, port_daemon):
        for name in ("DOCKER_SOCKETS", "PODMAN_SOCKETS", "CONTAINERD_SOCKETS"):
            monkeypatch.setattr(mod, name, [])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        ref = f"localhost:{s.getsockname()[1]}/app:latest"
    out, ref_out = wd / "port.json", wd / "jax.json"
    rc = cli.main(["image", "--device", "cpu", "-o", str(out), "--cache-dir", str(wd / "c1"),
                   ref])
    assert rc == 1 and not out.exists()
    err = capsys.readouterr().err
    assert "cannot reach registry" in err and "not ported" not in err
    with pytest.raises(RegistryError, match="cannot reach registry"):
        jax_cli.main(["image", "--backend", "cpu", "-o", str(ref_out), "--cache-dir",
                      str(wd / "c2"), ref])
    assert not ref_out.exists()
    assert cli.main(["image", "--device", "cpu"]) == 1


@pytest.mark.parametrize("parallel,host_fallback", [(1, False), (0, False), (1, True), (0, True)],
                         ids=["serial", "parallel", "serial-fallback", "parallel-fallback"])
def test_device_error_in_one_layer_fails_the_scan(env, monkeypatch, parallel, host_fallback):
    """A device that dies from its second batch on, in any layer: with the
    fallback off the image scan fails (no layer is reported without its
    secret scan); on, each layer's run walks the ladder to the exact host
    engine and the scan completes with the CPU scan's findings and
    ``Degraded``."""
    layers = env["layers"]
    extra = [layer({f"x{i}/gh.txt": f"t {GH}\n".encode()}) for i in range(3)]
    path = docker_save_tar(env["tree"].parent / f"err{parallel}{host_fallback}.tar",
                           [*layers[:2], *extra])
    want = None
    if host_fallback:
        want, _ = cli.scan_image(path, device="cpu", cache=new_cache("memory"),
                                 parallel=parallel, scanners=("secret",))
        assert not want.degraded
    calls = {"n": 0}
    real = TorchSecretScanner.run_batch

    def flaky(self, rows, n_live):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("device lost")
        return real(self, rows, n_live)

    monkeypatch.setattr(TorchSecretScanner, "run_batch", flaky)
    if not host_fallback:
        with pytest.raises(RuntimeError, match="device lost"):
            cli.scan_image(path, device="cpu", cache=new_cache("memory"), parallel=parallel,
                           scanners=("secret",), host_fallback=False)
        return
    got, stats = cli.scan_image(path, device="cpu", cache=new_cache("memory"),
                                parallel=parallel, scanners=("secret",))
    assert got.degraded and got.to_dict()["Degraded"] is True
    assert [r.to_dict() for r in got.results] == [r.to_dict() for r in want.results]
    assert got.to_dict()["Metadata"] == want.to_dict()["Metadata"]
    assert stats["degraded"] >= 1 and stats["scan.degraded"] == stats["degraded"]
    assert stats["batch_retries"] == 2 * stats["degraded"]
