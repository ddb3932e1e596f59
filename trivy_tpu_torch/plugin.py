"""Subprocess plugin system (ref: pkg/plugin), the port of
``trivy_tpu/plugin.py``.

Plugins are external executables installed under
``~/.trivy-tpu/plugins/<name>/`` (the JAX package's root, so either
package's CLI lists and runs what the other installed) with a
``plugin.yaml`` manifest
(ref: pkg/plugin/plugin.go:63-148):

    name: count
    version: 0.1.0
    summary: count findings
    platforms:
      - selector: {os: linux, arch: amd64}   # optional
        bin: ./count.py

``install`` copies a local directory or archive (network indexes are out
of scope here — zero egress; the reference additionally pulls from its
plugin index); ``run`` execs the platform binary with the user's args, the
scan-output-consuming model the reference uses
(ref: cmd/trivy/main.go:30-37 TRIVY_RUN_AS_PLUGIN re-exec).
"""

from __future__ import annotations

import os
import platform
import shutil
import subprocess
import tarfile

from trivy_tpu_torch import log

logger = log.logger("plugin")


class PluginError(RuntimeError):
    pass


def plugins_dir(root: str | None = None) -> str:
    return root or os.path.join(
        os.environ.get("TRIVY_TPU_HOME", os.path.expanduser("~/.trivy-tpu")),
        "plugins",
    )


def _load_manifest(plugin_dir: str) -> dict:
    import yaml

    path = os.path.join(plugin_dir, "plugin.yaml")
    if not os.path.exists(path):
        raise PluginError(f"{plugin_dir}: missing plugin.yaml")
    with open(path, encoding="utf-8") as f:
        manifest = yaml.safe_load(f) or {}
    if not manifest.get("name"):
        raise PluginError(f"{path}: manifest has no name")
    return manifest


def _select_bin(manifest: dict, plugin_dir: str) -> str:
    """Pick the platform binary (ref: plugin.go Platform selector match)."""
    sys_os = platform.system().lower()
    sys_arch = {"x86_64": "amd64", "aarch64": "arm64"}.get(
        platform.machine(), platform.machine()
    )
    chosen = None
    for p in manifest.get("platforms", []) or []:
        sel = p.get("selector") or {}
        if sel.get("os") and sel["os"] != sys_os:
            continue
        if sel.get("arch") and sel["arch"] != sys_arch:
            continue
        chosen = p
        break
    if chosen is None:
        raise PluginError(
            f"plugin {manifest['name']} supports no platform matching "
            f"{sys_os}/{sys_arch}"
        )
    bin_path = os.path.normpath(os.path.join(plugin_dir, chosen.get("bin", "")))
    root = os.path.normpath(plugin_dir)
    if os.path.commonpath([bin_path, root]) != root:
        raise PluginError(f"plugin binary escapes plugin dir: {chosen.get('bin')}")
    if not os.path.exists(bin_path):
        raise PluginError(f"plugin binary not found: {bin_path}")
    return bin_path


def install(source: str, root: str | None = None) -> dict:
    """Install from a local directory or .tar.gz archive; returns the
    manifest."""
    base = plugins_dir(root)
    os.makedirs(base, exist_ok=True)
    if os.path.isdir(source):
        manifest = _load_manifest(source)
        dest = os.path.join(base, manifest["name"])
        if os.path.exists(dest):
            shutil.rmtree(dest)
        shutil.copytree(source, dest)
    elif source.endswith((".tar.gz", ".tgz")):
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            try:
                with tarfile.open(source) as tf:
                    tf.extractall(td, filter="data")
            except tarfile.TarError as e:
                raise PluginError(f"cannot read plugin archive {source}: {e}") from e
            entries = sorted(os.listdir(td))
            if "plugin.yaml" in entries:
                src = td
            elif len(entries) == 1:
                src = os.path.join(td, entries[0])
            else:
                raise PluginError(
                    f"{source}: archive must contain plugin.yaml at its root "
                    "or exactly one plugin directory"
                )
            manifest = _load_manifest(src)
            dest = os.path.join(base, manifest["name"])
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.copytree(src, dest)
    else:
        raise PluginError(
            f"unsupported plugin source {source!r} (directory or .tar.gz; "
            "registry indexes need egress, which this build doesn't assume)"
        )
    logger.debug("installed plugin %s -> %s", manifest["name"], dest)
    return manifest


def uninstall(name: str, root: str | None = None) -> bool:
    dest = os.path.join(plugins_dir(root), name)
    if not os.path.isdir(dest):
        return False
    shutil.rmtree(dest)
    return True


def list_installed(root: str | None = None) -> list[dict]:
    base = plugins_dir(root)
    out = []
    if not os.path.isdir(base):
        return out
    for name in sorted(os.listdir(base)):
        pdir = os.path.join(base, name)
        if not os.path.isdir(pdir):
            continue
        try:
            out.append(_load_manifest(pdir))
        except PluginError as e:
            logger.warning("%s", e)
    return out


def run(name: str, args: list[str], root: str | None = None) -> int:
    """Exec the plugin binary with args; returns its exit code."""
    pdir = os.path.join(plugins_dir(root), name)
    if not os.path.isdir(pdir):
        raise PluginError(
            f"plugin {name!r} is not installed "
            f"(installed: {', '.join(m['name'] for m in list_installed(root)) or 'none'})"
        )
    manifest = _load_manifest(pdir)
    bin_path = _select_bin(manifest, pdir)
    proc = subprocess.run([bin_path, *args])
    return proc.returncode
