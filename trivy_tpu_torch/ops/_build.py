"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`. The
library lands in ``build/kernels/`` at the repository root (git-ignored),
named by a digest of its source and of every ``csrc/`` file it includes, so
an edited source or header rebuilds and an unchanged one loads at once.
Beside it lies ptxas's report of each kernel's registers, shared memory and
spills (``-Xptxas -v``). Nothing is built when a module is imported: the
first call that needs the kernel builds it.

The flight recorder (``obs/recorder.py``) counts each library :func:`load`
makes ready in a process as one compile of its kernel, in the bucket
``nvcc`` when :func:`build` ran the compiler for it and ``cached`` when the
library was already built, with the seconds of the build and the load.

Every failure to build, load or launch a kernel raises :class:`KernelError`:
``nvcc`` missing or failing, ``ctypes`` refusing the library, a setup or
launch returning an error code, a grid query finding that no block fits.
A CUDA error that the card raises later, at the copy or fetch that waits
on a kernel, is of the same kind (:func:`kernel_fault`). The scan ladder
never retries or degrades either, so a kernel that does not work fails the
scan instead of ending as a host scan.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch (see the module docstring)."""


def kernel_fault(err: BaseException) -> bool:
    """Whether ``err`` says a kernel does not work: a :class:`KernelError`,
    or a CUDA error that surfaced at a later copy or fetch (PyTorch's
    ``AcceleratorError``, or a message starting "CUDA error") that is not
    the card running out of memory."""
    if isinstance(err, KernelError):
        return True
    msg = str(err)
    if "out of memory" in msg.lower():
        return False
    return (any(c.__name__ == "AcceleratorError" for c in type(err).__mro__)
            or msg.startswith("CUDA error"))


_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
# C signatures of the exported entry points: (restype, argtypes)
SIGNATURES = {
    "match": {
        # smem_limit, smem, grid (out)
        "trivy_match_grid": (_I, [_I, _I, ctypes.POINTER(_I)]),
        "trivy_match_launch": (
            # x, B, C, R, image, image_words, seg, halo, smem, grid, out, stream
            _I, [_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P],
        ),
        "trivy_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "decompress": {
        # C, grid (out), smem (out)
        "trivy_decompress_grid": (_I, [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]),
        "trivy_decompress_launch": (
            # buf, W, offs, clen, mode, B, C, tab_bytes, tab_len, out, grid, smem, stream
            _I, [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P],
        ),
        "trivy_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "gram_gate": {
        "trivy_gram_gate_launch": (
            # x, B, C, blk, lut, gate, n_gate, anchor, n_anchor, screen, dir, P1, P2, HP,
            # ngram, out, stream
            _I, [_P, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P, _U, _U, _U, _I, _P, _P],
        ),
        "trivy_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "bytes_gate": {
        # s4_bits, s8_bits, smem (out)
        "trivy_bytes_gate_smem": (_I, [_I, _I, ctypes.POINTER(_I)]),
        "trivy_bytes_gate_launch": (
            # x, B, C, lut, bloom8, bloom4, screen4, s4_bits, screen8, s8_bits, blk, ah, nb,
            # partial, ticket, smem, stream
            _I, [_P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P],
        ),
        "trivy_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "verscmp": {
        # L, R, inst, bounds, out [G, U, vector path, grid]
        "trivy_verscmp_plan": (_I, [_I, _I, _P, _P, ctypes.POINTER(_I)]),
        "trivy_verscmp_launch": (
            # inst, n_inst, bounds, n_bounds, L, a_idx, b_idx, ops, R, verdict, sign, stream
            _I, [_P, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P],
        ),
        "trivy_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "bytes_score": {
        # C, S, out [threads, smem, clusters, blocks per SM]
        "trivy_bytes_score_plan": (_I, [_I, _I, ctypes.POINTER(_I)]),
        "trivy_bytes_score_launch": (
            # x, B, C, S, lut, keys, kdir, credit, ls, gcap, P1, P2, HP, ngram, full_w, phrase,
            # n_uniq, scratch, stream
            _I, [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _U, _U, _U, _I, _P, _P, _P, _P, _P],
        ),
        "trivy_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes with
    ``#include "..."``, directly or through another such file, in the order
    first reached."""
    root = CSRC.resolve()
    seen: list[Path] = []
    todo = [root / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and dep.is_relative_to(root):
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: named by a digest
    of the flags and of every source file it reads."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.relative_to(CSRC.resolve()).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """What ptxas printed when the library of ``csrc/<name>.cu`` was built:
    registers, shared memory and spills of each kernel."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path. Concurrent processes each compile into a
    temporary file and rename it into place."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C signatures
    declared (every pointer and the stream as ``c_void_p``)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            from trivy_tpu_torch.obs import recorder

            t0 = time.perf_counter()
            cached = library_path(name).exists()
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load the {name} kernel library {path}: {e}") from e
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
            recorder.note_compile(name, "cached" if cached else "nvcc",
                                  time.perf_counter() - t0)
        return lib


def preload(*names: str) -> None:
    """Build and load the libraries of ``names`` now, so that a kernel that
    cannot be built or loaded fails where its stage is set up on the card,
    not at its first launch inside a scan."""
    for name in names:
        load(name)
