"""Language lockfile analyzers: one generic analyzer per
(filename, app type, parser) (ref: pkg/fanal/analyzer/language/* — each
ecosystem registers a thin analyzer wrapping a dependency parser)."""

from __future__ import annotations

import os.path

from trivy_tpu_torch.dependency import parsers as P
from trivy_tpu_torch.fanal.analyzer import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    AnalyzerType,
    register_analyzer,
)
from trivy_tpu_torch.types import Application

# (analyzer type, app type, filename matcher, parser)
_SPECS = [
    (AnalyzerType.GO_MOD, "gomod", lambda n: n == "go.mod", P.parse_gomod),
    (AnalyzerType.NPM_PKG_LOCK, "npm", lambda n: n == "package-lock.json", P.parse_npm_lock),
    (AnalyzerType.YARN, "yarn", lambda n: n == "yarn.lock", P.parse_yarn_lock),
    (AnalyzerType.PNPM, "pnpm", lambda n: n == "pnpm-lock.yaml", P.parse_pnpm_lock),
    (AnalyzerType.PIP, "pip", lambda n: n == "requirements.txt", P.parse_requirements),
    (AnalyzerType.PIPENV, "pipenv", lambda n: n == "Pipfile.lock", P.parse_pipfile_lock),
    (AnalyzerType.POETRY, "poetry", lambda n: n == "poetry.lock", P.parse_poetry_lock),
    (AnalyzerType.UV, "uv", lambda n: n == "uv.lock", P.parse_uv_lock),
    (AnalyzerType.CARGO, "cargo", lambda n: n == "Cargo.lock", P.parse_cargo_lock),
    (AnalyzerType.BUNDLER, "bundler", lambda n: n == "Gemfile.lock", P.parse_gemfile_lock),
    (AnalyzerType.COMPOSER, "composer", lambda n: n == "composer.lock", P.parse_composer_lock),
    (AnalyzerType.GRADLE_LOCK, "gradle-lockfile", lambda n: n == "gradle.lockfile", P.parse_gradle_lock),
    (AnalyzerType.NUGET, "nuget", lambda n: n == "packages.lock.json", P.parse_nuget_lock),
    (AnalyzerType.CONAN, "conan-lock", lambda n: n in ("conan.lock",), P.parse_conan_lock),
    (AnalyzerType.MIX_LOCK, "mix-lock", lambda n: n == "mix.lock", P.parse_mix_lock),
    (AnalyzerType.PUB_SPEC, "pubspec-lock", lambda n: n == "pubspec.lock", P.parse_pubspec_lock),
    (AnalyzerType.COCOAPODS, "cocoapods", lambda n: n == "Podfile.lock", P.parse_podfile_lock),
    (AnalyzerType.SWIFT, "swift", lambda n: n == "Package.resolved", P.parse_swift_resolved),
    (AnalyzerType.JULIA, "julia", lambda n: n == "Manifest.toml", P.parse_julia_manifest),
    (AnalyzerType.DOTNET_DEPS, "dotnet-core", lambda n: n.endswith(".deps.json"), P.parse_dotnet_deps),
    (AnalyzerType.SBT_LOCK, "sbt-lockfile", lambda n: n == "build.sbt.lock", P.parse_sbt_lock),
    (AnalyzerType.CONDA_ENV, "conda-environment",
     lambda n: n in ("environment.yml", "environment.yaml"), P.parse_conda_environment),
    (AnalyzerType.PACKAGES_PROPS, "packages-props",
     lambda n: n in ("Packages.props", "Directory.Packages.props"), P.parse_packages_props),
]


def _make(analyzer_type, app_type, matcher, parser):
    class LockfileAnalyzer(Analyzer):
        type = analyzer_type
        version = 1

        def __init__(self, options):
            pass

        def required(self, file_path: str, info) -> bool:
            return matcher(os.path.basename(file_path))

        def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
            pkgs = parser(inp.content, inp.file_path)
            if not pkgs:
                return None
            return AnalysisResult(
                applications=[
                    Application(type=app_type, file_path=inp.file_path, packages=pkgs)
                ]
            )

    LockfileAnalyzer.__name__ = f"{app_type.title().replace('-', '')}Analyzer"
    return LockfileAnalyzer


for _t, _app, _match, _parse in _SPECS:
    if _parse is not None:
        register_analyzer(_make(_t, _app, _match, _parse))


class JarAnalyzer(Analyzer):
    """JAR identification: sha1 → Maven GAV via the java DB when configured
    (ref: parser/java/jar + pkg/javadb/client.go:24-47), with filename
    parsing as the offline fallback lane."""

    type = AnalyzerType.JAR
    version = 2

    def __init__(self, options):
        self._db = None
        db_path = (getattr(options, "extra", {}) or {}).get("java_db_path")
        if db_path:
            from trivy_tpu_torch.javadb import JavaDB

            self._db = JavaDB.load(db_path)

    def required(self, file_path: str, info) -> bool:
        return file_path.endswith((".jar", ".war", ".ear"))

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs = None
        if self._db is not None:
            gav = self._db.lookup_content(inp.content)
            if gav is not None:
                from trivy_tpu_torch.types import Package, PkgIdentifier

                group, artifact, version = gav
                name = f"{group}:{artifact}"
                pkgs = [Package(
                    name=name,
                    version=version,
                    file_path=inp.file_path,
                    identifier=PkgIdentifier(
                        purl=f"pkg:maven/{group}/{artifact}@{version}"
                    ),
                )]
        if pkgs is None:
            pkgs = P.parse_jar_name(inp.file_path)
        if not pkgs:
            return None
        return AnalysisResult(
            applications=[
                Application(type="jar", file_path=inp.file_path, packages=pkgs)
            ]
        )


class PomAnalyzer(Analyzer):
    """pom.xml with parent-chain/dependencyManagement resolution
    (ref: pkg/dependency/parser/java/pom/parse.go)."""

    type = AnalyzerType.POM
    version = 2

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return os.path.basename(file_path) == "pom.xml"

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        from trivy_tpu_torch.dependency.pom import Resolver, fs_loader

        if inp.dir:
            # parents resolve against the real scan tree
            abs_path = os.path.join(inp.dir, inp.file_path)

            def loader(path: str, _root=os.path.realpath(inp.dir)):
                # clamp parent lookups inside the scan root; realpath on
                # both sides so symlinked relativePaths cannot escape
                real = os.path.realpath(path)
                if os.path.commonpath([real, _root]) != _root:
                    return None
                return fs_loader(real)

            pkgs = Resolver(loader).resolve(inp.content, abs_path)
        else:  # image layers: no sibling files addressable — single pom
            pkgs = Resolver(lambda _p: None).resolve(inp.content, inp.file_path)
        if not pkgs:
            return None
        return AnalysisResult(
            applications=[
                Application(type="pom", file_path=inp.file_path, packages=pkgs)
            ]
        )


class WordPressAnalyzer(Analyzer):
    """WordPress core version from wp-includes/version.php (ref:
    pkg/dependency/parser/frameworks/wordpress)."""

    type = AnalyzerType.WORDPRESS
    version = 1

    def __init__(self, options):
        pass

    def required(self, file_path: str, info) -> bool:
        return file_path.endswith("wp-includes/version.php")

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs = P.parse_wordpress_version(inp.content, inp.file_path)
        if not pkgs:
            return None
        return AnalysisResult(
            applications=[
                Application(
                    type="wordpress", file_path=inp.file_path, packages=pkgs
                )
            ]
        )


register_analyzer(WordPressAnalyzer)
register_analyzer(JarAnalyzer)
register_analyzer(PomAnalyzer)
