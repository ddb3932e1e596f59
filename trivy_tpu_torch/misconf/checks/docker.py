"""Builtin Dockerfile checks (DS series), the port of
``trivy_tpu/misconf/checks/docker.py``.

Independently-authored equivalents of the reference's embedded Dockerfile
check bundle (ref: pkg/iac/rego/embed.go loads trivy-checks; the DS IDs are
the public, stable interface suppression configs rely on). Each check walks
the typed instruction stream from ``misconf.parse.dockerfile``.
"""

from __future__ import annotations

import re

from trivy_tpu_torch.misconf.checks import Check, Failure, register
from trivy_tpu_torch.misconf.parse.dockerfile import Dockerfile, Instruction

_DF = ("dockerfile",)
_URL = "https://avd.aquasec.com/misconfig/{}"


def _check(id_, avd, title, severity, desc="", res=""):
    def wrap(fn):
        register(
            Check(
                id=id_,
                avd_id=avd,
                title=title,
                severity=severity,
                file_types=_DF,
                fn=fn,
                description=desc,
                resolution=res,
                url=_URL.format(id_.lower()),
                service="general",
                provider="dockerfile",
            )
        )
        return fn

    return wrap


def _shell_commands(instr: Instruction) -> list[list[str]]:
    """RUN payload split into individual commands (on &&, ||, ;, |)."""
    if instr.json_form:
        return [instr.args] if instr.args else []
    text = instr.value.replace("\n", " ")
    cmds = []
    for part in re.split(r"&&|\|\||;|\|", text):
        words = part.split()
        if words:
            cmds.append(words)
    return cmds


def _runs(df: Dockerfile):
    for i in df.instructions:
        if i.cmd == "RUN":
            yield i


@_check("DS001", "AVD-DS-0001", "':latest' tag used", "MEDIUM",
        "Pinning image versions makes builds reproducible.",
        "Use a specific image tag or digest instead of 'latest'.")
def latest_tag(df: Dockerfile):
    aliases = {s.name for s in df.stages if s.name}
    for s in df.stages:
        base = s.base
        if not base or base.lower() in aliases or base == "scratch":
            continue
        if base.startswith("$"):  # ARG-parameterized base: not decidable
            continue
        if "@" in base:  # digest-pinned
            continue
        # tag is after the last ':' that is not part of a registry port
        name = base.rsplit("/", 1)[-1]
        tag = name.split(":", 1)[1] if ":" in name else ""
        if tag == "latest" or not tag:
            img = base.split(":", 1)[0]
            yield Failure(
                message=f"Specify a tag in the 'FROM' statement for image '{img}'",
                start_line=s.start_line,
                end_line=s.start_line,
            )


@_check("DS002", "AVD-DS-0002", "Image user should not be 'root'", "HIGH",
        "Running containers as root increases the blast radius of a compromise.",
        "Add 'USER <non-root>' as the last USER instruction.")
def root_user(df: Dockerfile):
    stage = df.final_stage
    if stage is None:
        return
    last_user = None
    for i in stage.instructions:
        if i.cmd == "USER":
            last_user = i
    if last_user is None:
        # inherited users from earlier stages count
        for i in df.instructions:
            if i.cmd == "USER":
                last_user = i
    if last_user is None:
        yield Failure(
            message="Specify at least 1 USER command in Dockerfile with non-root user as argument",
            start_line=stage.start_line,
            end_line=stage.start_line,
        )
        return
    user = last_user.value.split(":")[0].strip()
    if user in ("root", "0"):
        yield Failure(
            message="Last USER command in Dockerfile should not be 'root'",
            start_line=last_user.start_line,
            end_line=last_user.end_line,
        )


@_check("DS004", "AVD-DS-0004", "Port 22 exposed", "MEDIUM",
        "Exposing the SSH port invites remote shells into containers.",
        "Remove 'EXPOSE 22' and use 'docker exec' for debugging.")
def exposed_ssh(df: Dockerfile):
    for i in df.instructions:
        if i.cmd != "EXPOSE":
            continue
        for port in i.value.split():
            if port.split("/")[0] == "22":
                yield Failure(
                    message="Port 22 should not be exposed in Dockerfile",
                    start_line=i.start_line,
                    end_line=i.end_line,
                )


@_check("DS005", "AVD-DS-0005", "ADD instead of COPY", "LOW",
        "ADD has implicit archive extraction and URL fetching; COPY is explicit.",
        "Use COPY unless ADD's tar/URL semantics are required.")
def add_instead_of_copy(df: Dockerfile):
    for i in df.instructions:
        if i.cmd != "ADD":
            continue
        srcs = i.args[:-1]
        if any(s.startswith(("http://", "https://")) for s in srcs):
            continue
        if any(re.search(r"\.(tar|tar\.\w+|tgz|tbz2|txz)$", s) for s in srcs):
            continue
        yield Failure(
            message=f"Consider using 'COPY {i.value}' command instead of 'ADD {i.value}'",
            start_line=i.start_line,
            end_line=i.end_line,
        )


@_check("DS006", "AVD-DS-0006", "COPY '--from' references current image", "CRITICAL",
        "A stage cannot copy from its own alias.",
        "Reference an earlier stage or external image in '--from'.")
def copy_from_own_alias(df: Dockerfile):
    for s in df.stages:
        if not s.name:
            continue
        for i in s.instructions:
            if i.cmd == "COPY" and i.flags.get("from", "").lower() == s.name:
                yield Failure(
                    message=f"'COPY --from' should not mention the current FROM alias '{s.name}'",
                    start_line=i.start_line,
                    end_line=i.end_line,
                )


@_check("DS007", "AVD-DS-0007", "Multiple ENTRYPOINT instructions", "CRITICAL",
        "Only the last ENTRYPOINT takes effect; earlier ones are dead config.",
        "Keep a single ENTRYPOINT per stage.")
def multiple_entrypoint(df: Dockerfile):
    for s in df.stages:
        eps = [i for i in s.instructions if i.cmd == "ENTRYPOINT"]
        for extra in eps[1:]:
            yield Failure(
                message=f"There are {len(eps)} duplicate ENTRYPOINT instructions",
                start_line=extra.start_line,
                end_line=extra.end_line,
            )


@_check("DS008", "AVD-DS-0008", "Exposed port out of range", "CRITICAL",
        "Ports must be within 0-65535.", "Use a valid port number.")
def port_out_of_range(df: Dockerfile):
    for i in df.instructions:
        if i.cmd != "EXPOSE":
            continue
        for port in i.value.split():
            p = port.split("/")[0]
            if p.startswith("$"):
                continue
            try:
                v = int(p)
            except ValueError:
                continue
            if not (0 <= v <= 65535):
                yield Failure(
                    message=f"'EXPOSE' contains port which is out of range [0, 65535]: {v}",
                    start_line=i.start_line,
                    end_line=i.end_line,
                )


@_check("DS009", "AVD-DS-0009", "WORKDIR path not absolute", "HIGH",
        "Relative WORKDIR depends on previous state and breaks composability.",
        "Use an absolute path in WORKDIR.")
def workdir_relative(df: Dockerfile):
    for i in df.instructions:
        if i.cmd != "WORKDIR":
            continue
        path = i.value.strip("\"'")
        if path.startswith(("/", "$", "C:", "c:", "\\")):
            continue
        yield Failure(
            message=f"WORKDIR path '{path}' should be absolute",
            start_line=i.start_line,
            end_line=i.end_line,
        )


@_check("DS010", "AVD-DS-0010", "RUN using 'sudo'", "HIGH",
        "sudo in a container has unpredictable TTY/signal behavior.",
        "Run the build as the needed user instead of using sudo.")
def run_sudo(df: Dockerfile):
    for i in _runs(df):
        for cmd in _shell_commands(i):
            if cmd and cmd[0] == "sudo":
                yield Failure(
                    message="Using 'sudo' in Dockerfile should be avoided",
                    start_line=i.start_line,
                    end_line=i.end_line,
                )
                break


@_check("DS011", "AVD-DS-0011", "COPY with multiple sources needs dir dest", "CRITICAL",
        "COPY with several sources requires the destination to be a directory.",
        "End the destination with '/'.")
def copy_multiple_sources(df: Dockerfile):
    for i in df.instructions:
        if i.cmd != "COPY":
            continue
        args = i.args
        if len(args) > 2 and not args[-1].endswith(("/", "\\")) and not args[-1].startswith("$"):
            yield Failure(
                message=f"When copying multiple sources the destination '{args[-1]}' must end with '/'",
                start_line=i.start_line,
                end_line=i.end_line,
            )


@_check("DS012", "AVD-DS-0012", "Duplicate stage alias", "CRITICAL",
        "Two stages with the same alias make '--from' references ambiguous.",
        "Give each build stage a unique alias.")
def duplicate_alias(df: Dockerfile):
    seen: dict[str, int] = {}
    for s in df.stages:
        if not s.name:
            continue
        if s.name in seen:
            yield Failure(
                message=f"Duplicate aliases '{s.name}' are defined in multiple FROM instructions",
                start_line=s.start_line,
                end_line=s.start_line,
            )
        seen[s.name] = s.start_line


@_check("DS013", "AVD-DS-0013", "'RUN cd ...' to change directory", "MEDIUM",
        "cd in RUN only affects that layer; WORKDIR is persistent and explicit.",
        "Use WORKDIR to change the working directory.")
def run_cd(df: Dockerfile):
    for i in _runs(df):
        cmds = _shell_commands(i)
        # flag only a bare trailing 'cd' (cd chained into a command is fine)
        if cmds and cmds[-1] and cmds[-1][0] == "cd" and len(cmds) == 1:
            yield Failure(
                message=f"RUN should not be used to change directory: '{i.value}'. Use 'WORKDIR' statement instead.",
                start_line=i.start_line,
                end_line=i.end_line,
            )


@_check("DS014", "AVD-DS-0014", "'RUN wget' and 'RUN curl' both used", "LOW",
        "Mixing both fetch tools bloats the image.",
        "Standardize on either wget or curl.")
def wget_and_curl(df: Dockerfile):
    wget = curl = None
    for i in _runs(df):
        for cmd in _shell_commands(i):
            if not cmd:
                continue
            if cmd[0] == "wget" and wget is None:
                wget = i
            if cmd[0] == "curl" and curl is None:
                curl = i
    if wget is not None and curl is not None:
        later = max(wget, curl, key=lambda i: i.start_line)
        yield Failure(
            message="Shouldn't use both curl and wget",
            start_line=later.start_line,
            end_line=later.end_line,
        )


def _pkg_mgr_missing_clean(df, mgr: str, clean_words: tuple, message: str):
    for i in _runs(df):
        cmds = _shell_commands(i)
        installs = [
            c for c in cmds if len(c) >= 2 and c[0] == mgr and "install" in c
        ]
        if not installs:
            continue
        cleaned = any(
            c[0] == mgr and any(w in c for w in clean_words) for c in cmds
        ) or any(c and c[0] == "rm" for c in cmds)
        if not cleaned:
            yield Failure(
                message=message, start_line=i.start_line, end_line=i.end_line
            )


@_check("DS015", "AVD-DS-0015", "'yum clean all' missing", "HIGH",
        "Yum caches bloat the layer.", "Add 'yum clean all' after installs.")
def yum_clean(df: Dockerfile):
    yield from _pkg_mgr_missing_clean(
        df, "yum", ("clean",),
        "'yum clean all' is missed: 'yum install' should be followed by 'yum clean all'",
    )


@_check("DS016", "AVD-DS-0016", "Multiple CMD instructions", "CRITICAL",
        "Only the last CMD takes effect.", "Keep a single CMD per stage.")
def multiple_cmd(df: Dockerfile):
    for s in df.stages:
        cmds = [i for i in s.instructions if i.cmd == "CMD"]
        for extra in cmds[1:]:
            yield Failure(
                message=f"There are {len(cmds)} duplicate CMD instructions",
                start_line=extra.start_line,
                end_line=extra.end_line,
            )


@_check("DS017", "AVD-DS-0017", "'RUN <package-manager> update' alone", "HIGH",
        "An update layer without install in the same RUN caches stale indexes.",
        "Combine update and install in one RUN instruction.")
def update_alone(df: Dockerfile):
    for i in _runs(df):
        cmds = _shell_commands(i)
        has_update = any(
            len(c) >= 2 and c[0] in ("apt-get", "apt", "apk", "yum", "dnf", "zypper")
            and ("update" in c or "up" in c[1:2])
            for c in cmds
        )
        has_install = any(
            c and c[0] in ("apt-get", "apt", "apk", "yum", "dnf", "zypper")
            and ("install" in c or "add" in c)
            for c in cmds
        )
        if has_update and not has_install:
            yield Failure(
                message="The instruction 'RUN <package-manager> update' should always be followed by '<package-manager> install' in the same RUN statement",
                start_line=i.start_line,
                end_line=i.end_line,
            )


@_check("DS019", "AVD-DS-0019", "'dnf clean all' missing", "HIGH",
        "Dnf caches bloat the layer.", "Add 'dnf clean all' after installs.")
def dnf_clean(df: Dockerfile):
    yield from _pkg_mgr_missing_clean(
        df, "dnf", ("clean",),
        "'dnf clean all' is missed: 'dnf install' should be followed by 'dnf clean all'",
    )


@_check("DS020", "AVD-DS-0020", "'zypper clean' missing", "HIGH",
        "Zypper caches bloat the layer.", "Add 'zypper clean' after installs.")
def zypper_clean(df: Dockerfile):
    yield from _pkg_mgr_missing_clean(
        df, "zypper", ("clean", "cc"),
        "'zypper clean' is missed: 'zypper install' should be followed by 'zypper clean'",
    )


@_check("DS021", "AVD-DS-0021", "'apt-get install' without '-y'", "HIGH",
        "Without -y the build hangs on the confirmation prompt.",
        "Add '-y' (or '--yes') to apt-get install.")
def apt_get_yes(df: Dockerfile):
    for i in _runs(df):
        for c in _shell_commands(i):
            if len(c) >= 2 and c[0] == "apt-get" and "install" in c:
                if not any(
                    w in ("-y", "--yes", "--assume-yes", "-qy", "-yq") or
                    (w.startswith("-") and not w.startswith("--") and "y" in w[1:])
                    for w in c
                ):
                    yield Failure(
                        message=f"'-y' flag is missed: '{' '.join(c)}'",
                        start_line=i.start_line,
                        end_line=i.end_line,
                    )


@_check("DS022", "AVD-DS-0022", "Deprecated MAINTAINER used", "LOW",
        "MAINTAINER is deprecated.", "Use 'LABEL maintainer=...' instead.")
def maintainer(df: Dockerfile):
    for i in df.instructions:
        if i.cmd == "MAINTAINER":
            yield Failure(
                message=f"MAINTAINER should not be used: 'MAINTAINER {i.value}'",
                start_line=i.start_line,
                end_line=i.end_line,
            )


@_check("DS023", "AVD-DS-0023", "Multiple HEALTHCHECK instructions", "CRITICAL",
        "Only the last HEALTHCHECK takes effect.", "Keep a single HEALTHCHECK.")
def multiple_healthcheck(df: Dockerfile):
    hcs = [i for i in df.instructions if i.cmd == "HEALTHCHECK"]
    for extra in hcs[1:]:
        yield Failure(
            message="There are multiple HEALTHCHECK instructions",
            start_line=extra.start_line,
            end_line=extra.end_line,
        )


@_check("DS024", "AVD-DS-0024", "'apt-get dist-upgrade' used", "HIGH",
        "Full distribution upgrades inside images are unpredictable.",
        "Install pinned packages instead of dist-upgrading.")
def dist_upgrade(df: Dockerfile):
    for i in _runs(df):
        for c in _shell_commands(i):
            if len(c) >= 2 and c[0] == "apt-get" and "dist-upgrade" in c:
                yield Failure(
                    message="'apt-get dist-upgrade' should not be used in Dockerfile",
                    start_line=i.start_line,
                    end_line=i.end_line,
                )


@_check("DS025", "AVD-DS-0025", "'apk add' without '--no-cache'", "HIGH",
        "apk index caches bloat the layer.", "Use 'apk add --no-cache'.")
def apk_no_cache(df: Dockerfile):
    for i in _runs(df):
        for c in _shell_commands(i):
            if len(c) >= 2 and c[0] == "apk" and "add" in c and "--no-cache" not in c:
                yield Failure(
                    message=f"'--no-cache' is missed: '{' '.join(c)}'",
                    start_line=i.start_line,
                    end_line=i.end_line,
                )


@_check("DS026", "AVD-DS-0026", "No HEALTHCHECK defined", "LOW",
        "Without a healthcheck the orchestrator can't see container health.",
        "Add a HEALTHCHECK instruction.")
def no_healthcheck(df: Dockerfile):
    if not df.stages:
        return
    if not any(i.cmd == "HEALTHCHECK" for i in df.instructions):
        s = df.final_stage
        yield Failure(
            message="Add HEALTHCHECK instruction in your Dockerfile",
            start_line=s.start_line,
            end_line=s.start_line,
        )


@_check("DS029", "AVD-DS-0029", "'apt-get install' without '--no-install-recommends'", "HIGH",
        "Recommended packages bloat the image.",
        "Add '--no-install-recommends' to apt-get install.")
def apt_no_install_recommends(df: Dockerfile):
    for i in _runs(df):
        for c in _shell_commands(i):
            if len(c) >= 2 and c[0] == "apt-get" and "install" in c:
                if "--no-install-recommends" not in c:
                    yield Failure(
                        message=f"'--no-install-recommends' flag is missed: '{' '.join(c)}'",
                        start_line=i.start_line,
                        end_line=i.end_line,
                    )
