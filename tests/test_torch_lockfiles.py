"""The port's lockfile parsers, Maven resolver and Java DB against the JAX
package's: every parser on the same bytes (fixed fixtures and seeded
generated lockfiles), ``to_dict()`` lists equal. ``LOCKFILES`` (one file of
every kind the lockfile analyzers take) also builds the fs trees of
``test_torch_fs_vuln.py``."""

import hashlib
import json

import numpy as np
import pytest

from trivy_tpu import javadb as jax_javadb
from trivy_tpu.dependency import parsers as JP
from trivy_tpu.dependency import pom as jax_pom
from trivy_tpu_torch import javadb
from trivy_tpu_torch.dependency import parsers as P
from trivy_tpu_torch.dependency import pom

NPM_V3 = json.dumps({
    "name": "app", "lockfileVersion": 3,
    "packages": {
        "": {"name": "app", "dependencies": {"lodash": "^4.17.0", "a": "^1.0.0"},
             "devDependencies": {"d": "^1.0.0"}},
        "node_modules/lodash": {"version": "4.17.20", "license": "MIT"},
        "node_modules/a": {"version": "1.0.0", "dependencies": {"b": "^2.0.0"}},
        "node_modules/b": {"version": "2.0.0"},
        "node_modules/d": {"version": "1.0.0", "dev": True},
        "node_modules/a/node_modules/b": {"version": "2.5.0"},
        "node_modules/minimist": {"version": "1.2.0"},
    },
}).encode()

NPM_V1 = json.dumps({
    "dependencies": {
        "lodash": {"version": "4.17.19",
                   "dependencies": {"nested": {"version": "1.0.0"}}},
        "a": {"version": "1.0.0", "requires": {"b": "^2.0.0"},
              "dependencies": {"b": {"version": "2.5.0"}}},
        "b": {"version": "2.0.0"},
    },
}).encode()

GOMOD = b"""module example.com/app

go 1.21

require (
\tgithub.com/gin-gonic/gin v1.9.1
\tgolang.org/x/crypto v0.14.0 // indirect
\tgithub.com/old/pkg v1.0.0
)

require github.com/stretchr/testify v1.8.4

replace github.com/old/pkg => github.com/new/pkg v1.2.0

exclude golang.org/x/net v0.1.0
"""

YARN = b'''# yarn lockfile v1

lodash@^4.17.0, lodash@^4.17.15:
  version "4.17.21"
  resolved "https://registry.yarnpkg.com/lodash/..."
  dependencies:
    helper "^1.0.0"

helper@^1.0.0:
  version "1.0.3"

"@babel/core@^7.0.0":
  version "7.23.0"
'''

YARN_BERRY = b'''# This file is generated by running "yarn install"

__metadata:
  version: 8
  cacheKey: 10c0

"app@workspace:.":
  version: 0.0.0-use.local
  dependencies:
    lodash: "npm:^4.17.20"

"lodash@npm:^4.17.20":
  version: 4.17.21
  dependencies:
    helper: "npm:^1.0.0"

"helper@npm:^1.0.0":
  version: 1.2.0
'''

PNPM_V6 = b"""lockfileVersion: '6.0'
packages:
  /lodash@4.17.21:
    resolution: {integrity: sha512-x}
    dependencies:
      b: 2.0.0
  /b@2.0.0:
    resolution: {integrity: sha512-y}
  /@babel/core@7.23.0:
    resolution: {integrity: sha512-z}
"""

PNPM_V9 = b"""lockfileVersion: '9.0'
packages:
  a@1.0.0:
    resolution: {integrity: sha512-x}
  b@2.0.0:
    resolution: {integrity: sha512-y}
snapshots:
  a@1.0.0:
    dependencies:
      b: 2.0.0
  b@2.0.0: {}
"""

POETRY = b'''[[package]]
name = "flask"
version = "2.3.0"
category = "main"

[package.dependencies]
werkzeug = ">=2.3"

[[package]]
name = "werkzeug"
version = "2.3.4"
category = "main"

[[package]]
name = "pytest"
version = "7.0.0"
category = "dev"

[[package]]
name = "django"
version = "4.1.5"
category = "main"
'''

UV = b'''version = 1

[[package]]
name = "requests"
version = "2.31.0"
dependencies = [{ name = "idna" }]

[[package]]
name = "idna"
version = "3.4"
'''

CARGO = b'''[[package]]
name = "serde"
version = "1.0.190"
dependencies = [
 "serde_derive 1.0.190",
 "itoa",
]

[[package]]
name = "serde_derive"
version = "1.0.190"

[[package]]
name = "itoa"
version = "1.0.9"
'''

GEMFILE = (b"GEM\n  remote: https://rubygems.org/\n  specs:\n    rails (7.0.4)\n"
           b"      actionpack (= 7.0.4)\n    actionpack (7.0.4)\n\nDEPENDENCIES\n  rails\n")

COMPOSER = json.dumps({
    "packages": [
        {"name": "monolog/monolog", "version": "v3.5.0", "license": ["MIT"],
         "require": {"php": ">=8.1", "psr/log": "^2.0"}},
        {"name": "psr/log", "version": "v2.0.0"},
    ],
    "packages-dev": [{"name": "phpunit/phpunit", "version": "10.0.0"}],
}).encode()

NUGET = json.dumps({
    "version": 1,
    "dependencies": {"net6.0": {
        "Newtonsoft.Json": {"type": "Direct", "resolved": "13.0.1",
                            "dependencies": {"newtonsoft.json.bson": "1.0.2"}},
        "Newtonsoft.Json.Bson": {"type": "Transitive", "resolved": "1.0.2"},
    }},
}).encode()

CONAN = json.dumps({
    "graph_lock": {"nodes": {
        "0": {"ref": None},
        "1": {"ref": "openssl/3.0.8#abc", "requires": ["2"]},
        "2": {"ref": "zlib/1.2.13#def"},
    }},
}).encode()

MIX = b'''%{
  "phoenix": {:hex, :phoenix, "1.7.10", "HASH", [:mix], [{:plug, "~> 1.14", [hex: :plug, repo: "hexpm", optional: false]}, {:jason, "~> 1.0", [hex: :jason, repo: "hexpm", optional: true]}], "hexpm", "OUTER"},
  "plug": {:hex, :plug, "1.15.2", "HASH", [:mix], [], "hexpm", "OUTER"},
  "jason": {:hex, :jason, "1.4.1", "HASH", [:mix], [], "hexpm", "OUTER"},
}
'''

PUBSPEC = b"""packages:
  http:
    dependency: "direct main"
    version: "1.1.0"
  async:
    dependency: transitive
    version: "2.11.0"
  lints:
    dependency: "direct dev"
    version: "2.1.1"
"""

PODFILE = b"""PODS:
  - Alamofire (5.4.3)
  - AlamofireImage (4.2.0):
    - Alamofire (~> 5.4)
  - Firebase/Core (8.0.0):
    - FirebaseCore (= 8.0.0)
  - FirebaseCore (8.0.0)

DEPENDENCIES:
  - AlamofireImage
"""

SWIFT = json.dumps({"pins": [
    {"identity": "alamofire", "location": "https://github.com/Alamofire/Alamofire.git",
     "state": {"version": "5.8.0"}},
]}).encode()

DOTNET = json.dumps({
    "targets": {".NETCoreApp,Version=v6.0": {}},
    "libraries": {"Newtonsoft.Json/13.0.3": {"type": "package"},
                  "MyApp/1.0.0": {"type": "project"}},
}).encode()

JULIA = b'''julia_version = "1.9.0"
manifest_format = "2.0"

[[deps.ArgTools]]
uuid = "0dad84c5"
version = "1.1.1"

[[deps.HTTP]]
deps = ["ArgTools", "Sockets"]
uuid = "cd3eb016"
version = "1.9.5"

[[deps.Sockets]]
uuid = "6462fe0b"
'''

SBT = json.dumps({"lockVersion": 1, "dependencies": [
    {"org": "org.typelevel", "name": "cats-core_2.13", "version": "2.9.0",
     "configurations": ["compile"]},
]}).encode()

CONDA_ENV = b'''name: myenv
dependencies:
  - numpy=1.24.3=py311h64a7726_0
  - python>=3.10
  - pip:
    - requests==2.31.0
'''

PACKAGES_PROPS = b'''<Project>
  <ItemGroup>
    <PackageVersion Include="Serilog" Version="3.0.1" />
    <PackageVersion Include="Templated" Version="$(SerilogVersion)" />
  </ItemGroup>
</Project>
'''

WORDPRESS = b"""<?php
/* The WordPress version string.
 * $wp_version = '0.0.1';
 */
// $wp_version = '0.0.2';
$wp_version = '6.4.2';
"""

# (tree path, the parser's name, content): one of every lockfile kind
LOCKFILES = [
    ("go/go.mod", "parse_gomod", GOMOD),
    ("web/package-lock.json", "parse_npm_lock", NPM_V3),
    ("web/legacy/package-lock.json", "parse_npm_lock", NPM_V1),
    ("web/yarn.lock", "parse_yarn_lock", YARN),
    ("web/berry/yarn.lock", "parse_yarn_lock", YARN_BERRY),
    ("web/pnpm-lock.yaml", "parse_pnpm_lock", PNPM_V6),
    ("web/v9/pnpm-lock.yaml", "parse_pnpm_lock", PNPM_V9),
    ("py/requirements.txt", "parse_requirements", b"django==4.1.5\n# c\nflask>=2\nDjango==4.0.1\n"),
    ("py/Pipfile.lock", "parse_pipfile_lock",
     b'{"default": {"django": {"version": "==4.1.5"}}, '
     b'"develop": {"pytest": {"version": "==7.0.0"}}}'),
    ("py/poetry.lock", "parse_poetry_lock", POETRY),
    ("py/uv.lock", "parse_uv_lock", UV),
    ("rs/Cargo.lock", "parse_cargo_lock", CARGO),
    ("rb/Gemfile.lock", "parse_gemfile_lock", GEMFILE),
    ("php/composer.lock", "parse_composer_lock", COMPOSER),
    ("jvm/gradle.lockfile", "parse_gradle_lock",
     b"# comment\norg.slf4j:slf4j-api:2.0.9=runtimeClasspath\nempty=\n"),
    ("net/packages.lock.json", "parse_nuget_lock", NUGET),
    ("cpp/conan.lock", "parse_conan_lock", CONAN),
    ("ex/mix.lock", "parse_mix_lock", MIX),
    ("dart/pubspec.lock", "parse_pubspec_lock", PUBSPEC),
    ("ios/Podfile.lock", "parse_podfile_lock", PODFILE),
    ("swift/Package.resolved", "parse_swift_resolved", SWIFT),
    ("net/app.deps.json", "parse_dotnet_deps", DOTNET),
    ("jl/Manifest.toml", "parse_julia_manifest", JULIA),
    ("scala/build.sbt.lock", "parse_sbt_lock", SBT),
    ("conda/environment.yml", "parse_conda_environment", CONDA_ENV),
    ("net/Directory.Packages.props", "parse_packages_props", PACKAGES_PROPS),
    ("wp/wp-includes/version.php", "parse_wordpress_version", WORDPRESS),
]


def dicts(pkgs):
    return [p.to_dict() for p in pkgs]


def test_every_parser_has_a_fixture():
    names = {n for n in dir(JP) if n.startswith("parse_")} - {"parse_jar_name"}
    assert names == {name for _path, name, _c in LOCKFILES}
    assert {n for n in dir(P) if n.startswith("parse_")} == names | {"parse_jar_name"}


@pytest.mark.parametrize("path,name,content", LOCKFILES, ids=[p for p, _n, _c in LOCKFILES])
def test_parser_equals_jax(path, name, content):
    got = getattr(P, name)(content, path)
    assert got, f"{name} found no packages in its fixture"
    assert dicts(got) == dicts(getattr(JP, name)(content, path))


@pytest.mark.parametrize("path", [
    "libs/jackson-databind-2.15.2.jar", "lib/guava-31.1-jre.jar", "x/commons-io.jar",
    "a/b/log4j-core-2.14.1.war",
])
def test_jar_name_equals_jax(path):
    assert dicts(P.parse_jar_name(path)) == dicts(JP.parse_jar_name(path))


@pytest.mark.parametrize("name,content", [
    ("parse_npm_lock", b"{not json"), ("parse_gomod", b"\xff\xfe"),
    ("parse_cargo_lock", b"[[package]]\nname = 1\n"), ("parse_requirements", b""),
])
def test_parser_malformed_equals_jax(name, content):
    def outcome(fn):
        try:
            return dicts(fn(content, "x"))
        except Exception as e:  # the analyzer group logs a parser's error
            return type(e).__name__

    assert outcome(getattr(P, name)) == outcome(getattr(JP, name))


# -- seeded generated lockfiles ------------------------------------------------


def _version(rng) -> str:
    return ".".join(str(int(x)) for x in rng.integers(0, 30, size=3))


def gen_npm_lock(rng, n: int) -> bytes:
    pkgs = {"": {"name": "root", "dependencies": {}}}
    names = [f"pkg-{i}" for i in range(n)]
    for i, name in enumerate(names):
        entry = {"version": _version(rng)}
        if rng.random() < 0.3:
            entry["dev"] = True
        if rng.random() < 0.4:
            entry["dependencies"] = {names[int(j)]: "^1" for j in rng.integers(0, n, 2)}
        key = f"node_modules/{name}"
        if rng.random() < 0.2:  # nested under another package
            key = f"node_modules/{names[int(rng.integers(0, n))]}/{key}"
        if rng.random() < 0.5:
            pkgs[""]["dependencies"][name] = "^1"
        pkgs[key] = entry
    return json.dumps({"name": "root", "lockfileVersion": 3, "packages": pkgs}).encode()


def gen_gomod(rng, n: int) -> bytes:
    lines = ["module example.com/gen", "", "go 1.21", "", "require ("]
    for i in range(n):
        c = " // indirect" if rng.random() < 0.3 else ""
        lines.append(f"\tgithub.com/org{i % 7}/mod{i} v{_version(rng)}{c}")
    lines.append(")")
    for i in rng.integers(0, n, 3):
        lines.append(f"replace github.com/org{i % 7}/mod{i} => github.com/fork/mod{i} "
                     f"v{_version(rng)}")
    lines.append(f"exclude github.com/org0/mod0 v{_version(rng)}")
    return ("\n".join(lines) + "\n").encode()


def gen_cargo_lock(rng, n: int) -> bytes:
    out = []
    for i in range(n):
        out.append(f'[[package]]\nname = "crate{i % (n // 2 + 1)}"\nversion = "{_version(rng)}"')
        if rng.random() < 0.5:
            deps = ", ".join(f'"crate{int(j)}"' for j in rng.integers(0, n // 2 + 1, 2))
            out[-1] += f"\ndependencies = [{deps}]"
    return ("\n\n".join(out) + "\n").encode()


def gen_poetry_lock(rng, n: int) -> bytes:
    out = []
    for i in range(n):
        cat = "dev" if rng.random() < 0.3 else "main"
        block = f'[[package]]\nname = "py{i}"\nversion = "{_version(rng)}"\ncategory = "{cat}"'
        if rng.random() < 0.5:
            block += f'\n\n[package.dependencies]\npy{int(rng.integers(0, n))} = ">=1"'
        out.append(block)
    return ("\n\n".join(out) + "\n").encode()


GENERATORS = {
    "parse_npm_lock": gen_npm_lock, "parse_gomod": gen_gomod,
    "parse_cargo_lock": gen_cargo_lock, "parse_poetry_lock": gen_poetry_lock,
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generated_lockfile_equals_jax(name, seed):
    content = GENERATORS[name](np.random.default_rng(seed), 40 + 30 * seed)
    got = getattr(P, name)(content, "gen")
    assert len(got) >= 20
    assert dicts(got) == dicts(getattr(JP, name)(content, "gen"))


# -- Maven parent chain and the Java DB -----------------------------------------

GRANDPARENT = """<project><groupId>com.acme</groupId><artifactId>root</artifactId>
  <version>9</version><packaging>pom</packaging>
  <properties><jackson.version>2.15.2</jackson.version></properties>
  <dependencyManagement><dependencies>
    <dependency><groupId>com.fasterxml.jackson.core</groupId>
      <artifactId>jackson-databind</artifactId><version>${jackson.version}</version>
    </dependency>
  </dependencies></dependencyManagement>
</project>"""

PARENT = """<project xmlns="http://maven.apache.org/POM/4.0.0">
  <parent><groupId>com.acme</groupId><artifactId>root</artifactId><version>9</version>
    <relativePath>../pom.xml</relativePath></parent>
  <artifactId>parent</artifactId><version>1.2.3</version><packaging>pom</packaging>
  <properties><spring.version>5.3.30</spring.version>
    <shared.version>${project.version}</shared.version></properties>
  <dependencyManagement><dependencies>
    <dependency><groupId>org.springframework</groupId><artifactId>spring-core</artifactId>
      <version>${spring.version}</version></dependency>
    <dependency><groupId>junit</groupId><artifactId>junit</artifactId>
      <version>4.13.2</version><scope>test</scope></dependency>
  </dependencies></dependencyManagement>
  <dependencies><dependency><groupId>org.slf4j</groupId><artifactId>slf4j-api</artifactId>
    <version>2.0.9</version></dependency></dependencies>
</project>"""

CHILD = """<project xmlns="http://maven.apache.org/POM/4.0.0">
  <parent><groupId>com.acme</groupId><artifactId>parent</artifactId>
    <version>1.2.3</version></parent>
  <artifactId>app</artifactId>
  <dependencies>
    <dependency><groupId>org.springframework</groupId>
      <artifactId>spring-core</artifactId></dependency>
    <dependency><groupId>junit</groupId><artifactId>junit</artifactId></dependency>
    <dependency><groupId>com.fasterxml.jackson.core</groupId>
      <artifactId>jackson-databind</artifactId></dependency>
    <dependency><groupId>com.acme</groupId><artifactId>shared</artifactId>
      <version>${shared.version}</version></dependency>
  </dependencies>
</project>"""


def write_pom_chain(root):
    """``root/java/pom.xml`` (grandparent), ``root/java/parent/pom.xml``,
    ``root/java/parent/app/pom.xml`` (the child, resolved through both)."""
    (root / "java" / "parent" / "app").mkdir(parents=True)
    (root / "java" / "pom.xml").write_text(GRANDPARENT)
    (root / "java" / "parent" / "pom.xml").write_text(PARENT)
    (root / "java" / "parent" / "app" / "pom.xml").write_text(CHILD)


def test_resolver_parent_chain_equals_jax(tmp_path):
    write_pom_chain(tmp_path)
    path = str(tmp_path / "java" / "parent" / "app" / "pom.xml")
    got = pom.Resolver(pom.fs_loader).resolve(CHILD.encode(), path)
    want = jax_pom.Resolver(jax_pom.fs_loader).resolve(CHILD.encode(), path)
    assert dicts(got) == dicts(want)
    by_name = {p.name: p for p in got}
    assert by_name["com.fasterxml.jackson.core:jackson-databind"].version == "2.15.2"
    assert by_name["org.springframework:spring-core"].version == "5.3.30"
    assert by_name["junit:junit"].dev and by_name["com.acme:shared"].version == "1.2.3"
    # without the files on disk nothing is guessed, in both
    assert pom.Resolver(lambda _p: None).resolve(CHILD.encode(), "pom.xml") == [] == \
        jax_pom.Resolver(lambda _p: None).resolve(CHILD.encode(), "pom.xml")


JAR = b"PK\x03\x04" + b"log4jcontent"


def write_java_db(d) -> str:
    d.mkdir(parents=True, exist_ok=True)
    (d / "index.json").write_text(json.dumps({
        hashlib.sha1(JAR).hexdigest(): "org.apache.logging.log4j:log4j-core:2.14.1"}))
    (d / "metadata.json").write_text(json.dumps({"Version": 1}))
    return str(d)


def test_javadb_equals_jax(tmp_path):
    d = write_java_db(tmp_path / "javadb")
    mine, ref = javadb.JavaDB.load(d), jax_javadb.JavaDB.load(d)
    assert mine.by_sha1 == ref.by_sha1 and mine.metadata == ref.metadata
    for content in (JAR, b"other"):
        assert mine.lookup_content(content) == ref.lookup_content(content)
    assert mine.lookup_content(JAR) == ("org.apache.logging.log4j", "log4j-core", "2.14.1")
    # a missing or broken index: no DB, in both
    assert javadb.JavaDB.load(str(tmp_path)) is None is jax_javadb.JavaDB.load(str(tmp_path))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "index.json").write_text("[1]")
    assert javadb.JavaDB.load(str(tmp_path / "bad")) is None
    assert jax_javadb.JavaDB.load(str(tmp_path / "bad")) is None
