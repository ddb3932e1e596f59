"""The port's kernel build: library naming by digest and the ptxas report.

``nvcc`` exists only on a machine with a card, so the build here runs a
stand-in compiler that writes the output file and prints what ptxas prints.
"""

import stat

import pytest

from trivy_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    (src / "sub").mkdir(parents=True)
    (src / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint k;\n')
    (src / "a.cuh").write_text('#include "sub/b.cuh"\n')
    (src / "sub" / "b.cuh").write_text('  #  include "../a.cuh"\n')  # a cycle
    (src / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_digest_covers_included_files(csrc):
    assert [p.relative_to(csrc.resolve()).as_posix() for p in _build.sources("k")] == [
        "k.cu", "a.cuh", "sub/b.cuh"]
    first = _build.library_path("k")
    (csrc / "other.cuh").write_text("// edited, still not included\n")
    assert _build.library_path("k") == first
    (csrc / "sub" / "b.cuh").write_text('#include "../a.cuh"\n// edited\n')
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (csrc / "k.cu").write_text('#include "a.cuh"\nint k2;\n')
    assert _build.library_path("k") not in (first, second)


def test_build_keeps_the_ptxas_report(csrc, tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n'
        "echo \"ptxas info    : Used 48 registers, used 1 barriers\" >&2\n"
        "echo \"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\" >&2\n"
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    lib = _build.build("k")
    assert lib == _build.library_path("k") and lib.read_text() == "built\n"
    report = _build.ptxas_report("k")
    assert "Used 48 registers" in report and "0 bytes spill stores" in report
    assert "-Xptxas" in _build.NVCC_FLAGS and "-v" in _build.NVCC_FLAGS
    lib.write_text("cached\n")
    assert _build.build("k").read_text() == "cached\n"  # unchanged sources: no rebuild


def test_failed_build_raises_and_leaves_nothing(csrc, tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="error: bad"):
        _build.build("k")
    assert list((tmp_path / "build").iterdir()) == []
