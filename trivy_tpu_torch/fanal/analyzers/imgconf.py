"""Image-config analysis (ref: pkg/fanal/analyzer/imgconf/{secret,dockerfile,apk}),
the port of ``trivy_tpu/fanal/analyzers/imgconf.py``.

Analyzes the container *config* rather than layer contents: the
environment variables are scanned for secrets by the exact host engine,
with the ``misconfig`` scanner the build history is rebuilt as a Dockerfile
and run through the Dockerfile checks, and version-pinned ``apk add``
packages are read from the history. The result is one blob that the image
artifact puts on top of its layers.
"""

from __future__ import annotations

import os.path
import re

from trivy_tpu_torch.fanal.applier import APK_HISTORY_TARGET
from trivy_tpu_torch.types import BlobInfo, Package, PackageInfo, PkgIdentifier

# pseudo-paths for config-derived findings (rendered as scan targets)
ENV_TARGET = "container image config (env)"
HISTORY_TARGET = "Dockerfile (image history)"

# the instructions a history entry may start with; anything else is a RUN
_INSTRUCTIONS = {
    "FROM", "RUN", "CMD", "LABEL", "MAINTAINER", "EXPOSE", "ENV", "ADD", "COPY", "ENTRYPOINT",
    "VOLUME", "USER", "WORKDIR", "ARG", "ONBUILD", "STOPSIGNAL", "HEALTHCHECK", "SHELL",
}


def history_to_dockerfile(config: dict) -> str:
    """Reconstruct an approximate Dockerfile from config history
    (ref: imgconf/dockerfile/dockerfile.go builds scanner input the same
    way: each created_by entry becomes an instruction)."""
    lines = []
    for h in config.get("history", []):
        cmd = (h.get("created_by") or "").strip()
        if not cmd:
            continue
        # strip the classic builder prefixes
        for prefix in ("/bin/sh -c #(nop) ", "/bin/sh -c #(nop)"):
            if cmd.startswith(prefix):
                cmd = cmd[len(prefix):].strip()
                break
        else:
            if cmd.startswith("/bin/sh -c "):
                cmd = "RUN " + cmd[len("/bin/sh -c "):]
        # buildkit style: "RUN /bin/sh -c cmd # buildkit"
        if cmd.endswith("# buildkit"):
            cmd = cmd[: -len("# buildkit")].strip()
        if cmd.split(" ", 1)[0].upper() not in _INSTRUCTIONS:
            cmd = f"RUN {cmd}"
        lines.append(cmd)
    return "\n".join(lines) + ("\n" if lines else "")


def analyze_image_config(config: dict, secret: bool, secret_config_path: str | None = None,
                         misconfig: bool = False) -> BlobInfo:
    """The config's blob: with ``secret``, the ENV secrets (under the rules
    of ``secret_config_path`` when that file exists); with ``misconfig``,
    the history's Dockerfile checks under :data:`HISTORY_TARGET`; always,
    the apk history packages."""
    blob = BlobInfo()

    # ENV secrets (ref: imgconf/secret — env vars as scannable content)
    envs = config.get("config", {}).get("Env") or []
    if envs and secret:
        from trivy_tpu_torch.secret.engine import ScannerConfig, SecretScanner

        cfg = None
        if secret_config_path and os.path.exists(secret_config_path):
            cfg = ScannerConfig.from_yaml_file(secret_config_path)
        content = "\n".join(str(e) for e in envs).encode()
        found = SecretScanner(cfg).scan_bytes(ENV_TARGET, content)
        if found.findings:
            blob.secrets.append(found)

    # history misconfig (ref: imgconf/dockerfile): every registered check,
    # custom ones included, whatever --misconfig-scanners says, as in JAX
    if misconfig:
        dockerfile_text = history_to_dockerfile(config)
        if dockerfile_text:
            from trivy_tpu_torch.misconf import MisconfScanner

            mc = MisconfScanner().scan_file("Dockerfile", dockerfile_text.encode())
            if mc is not None and (mc.failures or mc.successes):
                mc.file_path = HISTORY_TARGET
                blob.misconfigurations.append(mc)

    # apk packages named in history commands (ref: imgconf/apk — for images
    # whose package DB was stripped, the `apk add` history still names what
    # was installed). Only VERSION-PINNED packages are emitted: an empty
    # installed version compares below every fixed version in the detector,
    # which would flag every fixed CVE ever recorded — worse than silence.
    apk_pkgs = apk_history_packages(config)
    if apk_pkgs:
        blob.package_infos.append(PackageInfo(file_path=APK_HISTORY_TARGET, packages=apk_pkgs))
    return blob


# apk flags that consume the following token as their argument
_APK_FLAGS_WITH_ARG = {
    "-t", "--virtual", "-X", "--repository", "-p", "--root", "--cache-dir",
    "--repositories-file", "--arch", "--wait",
}


def apk_history_packages(config: dict) -> list[Package]:
    """Version-pinned packages installed by ``apk add`` across the build
    history, minus anything later removed by ``apk del`` (incl. -t/--virtual
    group deletions — the add-build-deps/del-build-deps pattern)."""
    # leading "." marks a virtual group name (apk del .build-deps)
    name_re = re.compile(r"\.?[a-z0-9][a-z0-9_.+-]*")
    added: dict[str, str] = {}  # name -> version ("" when unpinned)
    virtual: dict[str, list[str]] = {}  # virtual group -> member names
    for h in config.get("history", []):
        cmd = h.get("created_by") or ""
        # each shell segment parses independently; flags may precede or
        # follow the subcommand and may take space-separated arguments
        for segment in re.split(r"&&|\|\||;|\|", cmd):
            tokens = segment.split()
            try:
                apk_i = tokens.index("apk")
            except ValueError:
                continue
            verb = None
            group = None
            names: list[tuple[str, str]] = []
            i = apk_i + 1
            while i < len(tokens):
                tok = tokens[i]
                if tok.startswith("-"):
                    flag, eq, inline_arg = tok.partition("=")
                    if eq:
                        # --virtual=.deps form: the argument rides the token
                        if flag in ("-t", "--virtual"):
                            group = inline_arg
                    elif flag in _APK_FLAGS_WITH_ARG:
                        i += 1
                        if flag in ("-t", "--virtual") and i < len(tokens):
                            group = tokens[i]
                    i += 1
                    continue
                if verb is None:
                    if tok in ("add", "del"):
                        verb = tok
                    elif not name_re.fullmatch(tok):
                        break  # not a parseable apk invocation
                    i += 1
                    continue
                name, _, version = tok.partition("=")
                if name_re.fullmatch(name):
                    names.append((name, version))
                i += 1
            if verb == "add":
                real = [(n, v) for n, v in names if not n.startswith(".")]
                if group:
                    virtual[group] = [n for n, _v in real]
                for name, version in real:
                    added[name] = version
            elif verb == "del":
                for name, _v in names:
                    for member in virtual.pop(name, [name]):
                        added.pop(member, None)
    return [
        Package(
            name=name,
            version=version,
            identifier=PkgIdentifier(purl=f"pkg:apk/alpine/{name}@{version}"),
        )
        for name, version in sorted(added.items())
        if version  # unpinned: unknowable version, see analyze_image_config
    ]
