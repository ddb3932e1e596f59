"""Installed-package analyzers: metadata of packages already installed on
the filesystem (vs lockfiles, which describe what *will* be installed).

- node-pkg: ``node_modules/**/package.json`` name/version/license
  (ref: pkg/fanal/analyzer/language/nodejs/pkg/pkg.go)
- python-pkg: ``*.dist-info/METADATA`` and ``*.egg-info/PKG-INFO`` headers
  (ref: pkg/fanal/analyzer/language/python/packaging/packaging.go)
- gemspec: ``specifications/*.gemspec`` declarations
  (ref: pkg/fanal/analyzer/language/ruby/gemspec)
- conda-pkg: ``conda-meta/*.json``
  (ref: pkg/fanal/analyzer/language/conda/meta)
"""

from __future__ import annotations

import json
import os.path
import re

from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerType,
    register_analyzer,
)
from trivy_tpu_torch.types import Application, Package, PkgIdentifier


def _app(app_type: str, path: str, pkgs: list[Package]) -> AnalysisResult | None:
    if not pkgs:
        return None
    return AnalysisResult(
        applications=[Application(type=app_type, file_path=path, packages=pkgs)]
    )


class NodePkgAnalyzer(Analyzer):
    type = AnalyzerType.NODE_PKG
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return (
            os.path.basename(file_path) == "package.json"
            and "node_modules/" in file_path
        )

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            doc = json.loads(inp.content)
        except (json.JSONDecodeError, ValueError):
            return None
        name, version = doc.get("name"), doc.get("version")
        if not name or not version or not isinstance(name, str):
            return None
        lic = doc.get("license")
        if isinstance(lic, dict):  # legacy {"type": ..., "url": ...}
            lic = lic.get("type")
        licenses = [lic] if isinstance(lic, str) and lic else []
        pkg = Package(
            name=name,
            version=str(version),
            licenses=licenses,
            file_path=inp.file_path,
            identifier=PkgIdentifier(purl=f"pkg:npm/{name}@{version}"),
        )
        return _app("node-pkg", inp.file_path, [pkg])


_META_NAME = re.compile(r"^Name:\s*(.+)$", re.MULTILINE)
_META_VERSION = re.compile(r"^Version:\s*(.+)$", re.MULTILINE)
_META_LICENSE = re.compile(r"^License(?:-Expression)?:\s*(.+)$", re.MULTILINE)
_META_CLASSIFIER_LICENSE = re.compile(
    r"^Classifier:\s*License\s*::\s*(?:OSI Approved\s*::\s*)?(.+)$", re.MULTILINE
)


class PythonPkgAnalyzer(Analyzer):
    type = AnalyzerType.PYTHON_PKG
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path.endswith((".dist-info/METADATA", ".egg-info/PKG-INFO", ".egg-info"))

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        text = inp.content.decode("utf-8", "replace")
        header = text.split("\n\n", 1)[0]  # body is the long description
        name_m = _META_NAME.search(header)
        ver_m = _META_VERSION.search(header)
        if not name_m or not ver_m:
            return None
        name, version = name_m.group(1).strip(), ver_m.group(1).strip()
        licenses = []
        lic_m = _META_LICENSE.search(header)
        # the License header is free-form and sometimes the full text;
        # prefer the trove classifier when the header is unhelpful
        if lic_m and lic_m.group(1).strip().upper() not in ("", "UNKNOWN") \
                and len(lic_m.group(1)) < 64:
            licenses.append(lic_m.group(1).strip())
        elif (cls_m := _META_CLASSIFIER_LICENSE.search(header)) is not None:
            licenses.append(cls_m.group(1).strip())
        pkg = Package(
            name=name,
            version=version,
            licenses=licenses,
            file_path=inp.file_path,
            identifier=PkgIdentifier(purl=f"pkg:pypi/{name.lower()}@{version}"),
        )
        return _app("python-pkg", inp.file_path, [pkg])


_GEM_ATTR = re.compile(
    r"\.\s*(name|version|licenses?)\s*=\s*(.+)$", re.MULTILINE
)
_GEM_STR = re.compile(r"[\"']([^\"']+)[\"']")


class GemspecAnalyzer(Analyzer):
    type = AnalyzerType.GEMSPEC
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path.endswith(".gemspec") and "specifications/" in file_path

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        text = inp.content.decode("utf-8", "replace")
        name = version = None
        licenses: list[str] = []
        for m in _GEM_ATTR.finditer(text):
            attr, value = m.group(1), m.group(2)
            strings = _GEM_STR.findall(value)
            if attr == "name" and strings:
                name = strings[0]
            elif attr == "version" and strings:
                version = strings[0]
            elif attr.startswith("license") and strings:
                licenses.extend(strings)
        if not name or not version:
            return None
        pkg = Package(
            name=name,
            version=version,
            licenses=licenses,
            file_path=inp.file_path,
            identifier=PkgIdentifier(purl=f"pkg:gem/{name}@{version}"),
        )
        return _app("gemspec", inp.file_path, [pkg])


class CondaPkgAnalyzer(Analyzer):
    type = AnalyzerType.CONDA_PKG
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path.endswith(".json") and "conda-meta/" in file_path

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        try:
            doc = json.loads(inp.content)
        except (json.JSONDecodeError, ValueError):
            return None
        name, version = doc.get("name"), doc.get("version")
        if not name or not version:
            return None
        lic = doc.get("license")
        pkg = Package(
            name=name,
            version=str(version),
            licenses=[lic] if isinstance(lic, str) and lic else [],
            file_path=inp.file_path,
            identifier=PkgIdentifier(purl=f"pkg:conda/{name}@{version}"),
        )
        return _app("conda-pkg", inp.file_path, [pkg])


register_analyzer(NodePkgAnalyzer)
register_analyzer(PythonPkgAnalyzer)
register_analyzer(GemspecAnalyzer)
register_analyzer(CondaPkgAnalyzer)
