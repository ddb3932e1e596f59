"""Untraced scans of two checkouts of the port, in turns on one card, to tell
a change's end-to-end effect from the spread between runs.

    python -m tools.scan_pairs <checkout A> <checkout B> [--order ABBA]
        [--mib 128] [--device cuda]

Each run is a process of its own started from one checkout's root (both
hold a package named ``trivy_tpu_torch``), importing that checkout's
``chip_smoke.py`` for its seeded trees: ``fs --scanners secret`` twice on
a seeded tree of ``--mib`` MiB (the ``e2e`` phase's generator), then, on
the ``fs-vuln`` phase's tree with its advisory DB loaded once,
``vuln`` on the device, ``vuln,secret,license`` on the device, on the CPU
and on the device again. Each run prints one JSON line of seconds; the
card's name and power limit follow the last run. A development tool
outside the package, like ``tools/kernel_study.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

SCANS = ((("vuln",), "device"), (("vuln", "secret", "license"), "device"),
         (("vuln", "secret", "license"), "cpu"), (("vuln", "secret", "license"), "device"))


def run_side(label: str, mib: int, device: str) -> dict:
    """The scans of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    import torch
    from trivy_tpu_torch import cli
    from trivy_tpu_torch.db import VulnDB
    from trivy_tpu_torch.detector import library

    if device == "cuda":
        torch.cuda.set_device(0)
        with ThreadPoolExecutor(len(cs.LIBRARIES)) as pool:
            list(pool.map(cs._build.build, cs.LIBRARIES))
    tmp = cs.REPO / ".chip_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    out: dict = {"side": label}
    try:
        base = cs.text_base(random.Random(0), 1 << 20)
        cs.write_tree(tmp / "tree", mib, 0, base)
        (tmp / "o").mkdir()
        for i in range(2):
            t0 = time.perf_counter()
            cs.run_cli(tmp / "tree", tmp / "o", f"e2e{i}", device)
            out.setdefault("secret_s", []).append(time.perf_counter() - t0)
        shutil.rmtree(tmp / "tree")
        cs.write_cve_db(tmp / "cve" / "db")
        cs.write_fs_tree(tmp / "fs" / "tree", 0, base)
        db = VulnDB.load(str(tmp / "cve" / "db"))
        library._resident_join(db)
        for scanners, where in SCANS:
            dev = device if where == "device" else "cpu"
            t0 = time.perf_counter()
            cli.scan_fs(str(tmp / "fs" / "tree"), scanners=scanners, db=db, device=dev)
            key = f"fs_{','.join(scanners)}_{where}_s"
            out.setdefault(key, []).append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", nargs="?", help="checkout A")
    ap.add_argument("b", nargs="?", help="checkout B")
    ap.add_argument("--order", default="ABBA", help="runs in turn, by letter")
    ap.add_argument("--mib", type=int, default=128, help="size of the secret-scan tree")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run is not None:
        print(json.dumps(run_side(args.run, args.mib, args.device)), flush=True)
        return 0
    sides = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    for letter in args.order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--run", f"{letter}:{sides[letter]}",
             "--mib", str(args.mib), "--device", args.device],
            cwd=sides[letter], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    if args.device == "cuda":
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
