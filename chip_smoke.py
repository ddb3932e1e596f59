#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's secret, license, SBOM, filesystem
vulnerability, image (archive, registry, daemon), repository and VM scans,
its incremental scans and ``watch``, its report formats, its multi-device
dispatch, its client/server mode and its fleet (coordinator and replicas) on
one NVIDIA card.

    python3 chip_smoke.py [--e2e-mib 48] [--license-mib 48] [--image-mib 32]
        [--seed 0]

Phases, each printing JSON lines:

1. build: compile the six kernel sources ``trivy_tpu_torch/ops/csrc/
   {match,decompress,gram_gate,bytes_gate,bytes_score,verscmp}.cu`` with nvcc for
   sm_90a, all at once, with ptxas's report of each kernel's registers,
   shared memory and spills; the card's name and power limit from
   nvidia-smi.
2. check: the matcher against its plain PyTorch version (``match_plain``)
   on the card, for both uses of the matcher (the keyword prefilter and the
   anchored matcher), on a seeded batch at the scanner's dispatch shape with
   the built-in rule samples planted at the row edges, on a custom ruleset
   with a negated class, negative offsets and a 130-byte run, and on one
   with 1- and 2-byte keywords and a 3-byte anchor, each at the full and a
   short batch (the custom rulesets are those of
   ``tests/test_torch_rulesets.py``). Then the decompress kernel against
   ``decompress_plain`` on frames the port's codec encodes from seeded
   text, random-byte, zero and mixed rows, at the dispatch shape and at a
   short batch padded to the smallest bucket, and on hand-built edge frames
   (streams at the buffer's edges, a token stream crossing the row end, a
   mode byte of 3, empty rows), on a wire buffer whose length is no
   multiple of 16 with streams at every offset mod 16, and on the mixed
   frame from a wire buffer one byte off 16-byte alignment; the decoded
   rows must also equal the rows they were encoded from. Outputs are booleans or bytes: ``torch.equal``
   is required (tolerance zero). Then the license kernels against their
   plain versions on the card, with the classifier's own tables: the gram
   gate (``torch.equal`` on its lane bits) on [1024, 16384] batches of
   seeded text with planted license texts and non-ASCII bytes, of license
   text (the prescreen's hits) and of random bytes, with the share of
   gram keys that pass the prescreen; the shingle gate (``torch.equal``)
   at every rung of the text-row ladder, and, called twice each, on rows
   inside one tile, on rows that straddle or span its tiles, on more tiles than the
   card has SMs and on rows one byte off 16-byte alignment; the scorer at every rung, at
   every cluster size its launch policy can choose there, on the full
   dispatch and on batches of 8, 16 and 64 rows gathered from it as the
   classifier gathers flagged rows, on license texts, a row whose
   repeated grams exceed the cap while its distinct grams fit, a row
   without words, one word over the whole row, a word across every
   16-byte boundary and one key repeated ~2,000 times (a bucket that
   spills to the device scratch) (``n_uniq`` and ``phrase`` with
   ``torch.equal``, ``full_w`` within rtol 1e-5, its
   ``max_abs_err`` printed). Then the version-constraint kernel against its
   plain version (``torch.equal``) at widths 1, 8, 24, 40 and 72, on rows
   that are equal, differ only in the last column or anywhere, with every
   operator, through the gather entry and the null-index entries
   (``lexcmp``, ``check_ops``); in phase 8 also on the captured ``cve``
   dispatch and, with its inst rows, indices and ops, against a DB of
   212,000 distinct bound rows (the ``check`` line ``verscmp-distinct``).
3. timing: each matcher use over about 1 GiB of resident rows of each of
   four inputs (seeded source text; the checkout's own ``trivy_tpu/``
   Python files, real code whose words include many rule keywords; uniform
   random bytes; keyword-dense text made of the first bytes of every
   literal of that use, the verify step's worst case), timed with CUDA
   events after a warm-up and behind a device spin that keeps the host's
   enqueueing out of the time (median of three rounds), beside the plain
   version on the source text, the least time the card could take (bytes
   over 3.35 TB/s) and the share of positions that pass the kernel's
   screen. The decompress kernel the same way on seeded-text and mixed
   frames, with its bound from each frame's actual wire bytes, the plain
   version's time, the host's encode time per batch (``plan`` + ``emit``)
   and the pinned host-to-card copy of the wire beside that of the raw
   slab, and the work (kernels, fills, copies) one wrapper call puts on
   the stream: the nodes of a CUDA graph captured around it. The gram gate on four
   [1024, 16384] batches of seeded text and one of license text, the
   shingle gate (with its work per call, which must be one kernel and
   nothing else, and the share of windows its screens pass on license and on
   source rows) and the scorer at their dispatch shapes, and the scorer on gathered batches of 8 and 64 rows at 1024,
   16384 and 49152, each beside its plain version, with its bound from
   this run's inputs (the scorer's from the distinct credit rows its rows
   actually gather), the scorer with its cluster size, threads, shared
   memory and blocks per SM, and at 1024, 16384 and 49152 also its time at
   every other cluster size whose slices hold up to 16 KiB. In phase 8
   the version-constraint kernel on the captured ``cve`` dispatch and on
   distinct bounds, warm (``time_cuda``) and with a cold L2 (a 256 MiB
   write before each launch, events around the launch alone, median of
   25), each beside its bound and plain version, with the launch's plan
   (lanes per row, rows per group, vector path, grid); and the dispatch
   split (the ``verscmp-dispatch`` line): the arrays gathered into the
   pinned buffer, the one host-to-card copy, the kernel and the copy back,
   in turns with the route it replaced (the same gathers into new arrays,
   four pageable uploads, the kernel, ``.cpu()``), and the work one
   dispatch puts on the stream.
4. e2e: a seeded tree (1 MiB text files, 2% with a planted secret, some
   thousands of small files, binaries, node_modules/, a lockfile and a CRLF
   file) scanned by ``python -m trivy_tpu_torch fs --scanners secret``'s
   entry point on the card with its default feed (dedup and compression
   on), with the kernels' launch counters set to 0 just before and read
   just after. Every planted secret must be reported under its rule with
   its line, and every kernel must have launched. The same tree on the raw
   feed (``--secret-compress off``) must give the same Results; its time
   weighs the codec's host work against the link bytes. On a 16 MiB subset the
   Results must equal the port's own ``--device cpu`` run, with and without
   dedup and compression.
5. dedup: the subset's first 2 MiB of files (``DEDUP_COPY_BYTES``), a
   verbatim copy of them, eight 1 MiB zero-filled files
   (after a short text head, so that the analyzer's binary sniff keeps
   them) and a planted 1 MiB file with its copy, scanned on the card: rows
   must dedup and zero rows must be gated, every planted secret must be
   reported in both copies, the Results must equal ``--device cpu
   --no-secret-dedup --secret-compress off``, and with
   ``--secret-hit-cache --cache-dir`` a second run must dispatch no batch
   and give the same Results.
6. license: a seeded tree of about 48 MiB (``--license-mib``): the e2e
   tree's source text, 2,048 license files (each of the 22 full texts raw,
   re-wrapped and with CRLF line ends, padded with source text to every
   width rung and past the widest), source files with license headers, and
   a subset directory. ``fs --scanners secret,license --license-full`` on
   the card, with the launch counters set to 0 just before and read just
   after: every planted license must be reported under its name, and the
   gram gate, shingle gate and scorer must have launched (the shingle
   gate's and the scorer's launches are also counted per [rows, width]). The gate's
   selection is printed, with the rows each of its lanes (gram, anchor,
   non-ASCII) flagged. The same tree with ``--scanners secret`` gives the
   secret-only MB/s beside it, and with ``--no-shared-arena`` (no gate)
   the unfused MB/s and the same Results; on the subset the Results must
   equal ``--device cpu``.
6b. feed: the feed's knobs. The e2e tree's 16 MiB ``sub16`` subset
   scanned on the card at the
   default one stream with two batches in flight and at four streams with
   one (``FEED_GRID``; ``--parallel`` runs at its default only), each
   under ``torch.profiler`` with ``--metrics-out``: the MB/s, the streams'
   ``secret.feed_wait`` share, the card's busy share (kernel time over the
   scan's wall time), the stall verdict and the launches, with ``Results``
   equal to the e2e phase's ``--device cpu`` scan of the subset. The
   race probe (two slabs,
   four streams, three in flight, 64-row batches) with equal ``Results``.
   An autotune record of the sweep's best setting written with
   ``tuning.save_autotune`` in the phase's directory, which a
   ``--tuning-file`` scan must resolve from (``source: autotune``). The
   subset and the license phase's subset with ``--tune``: their ``--device
   cpu`` Results, the controller's ticks and decisions. The redis
   cache against the fake RESP server of ``tests/test_redis_cache.py``:
   ``--secret-hit-cache`` cold, warm (no batch dispatched) and with every
   GET failing (``CacheDegraded``), each with the subset's ``--device cpu``
   Results.
7. license-repo: the same scans, fused, unfused and secret-only, twice
   each, on the checkout's own code (``trivy_tpu/``, ``trivy_tpu_torch/``
   and ``tests/``): the gate's selection on real code.
8. cve: this slice's main path. A seeded flattened advisory DB shaped
   like ``bench.py::bench_cve``'s (106,000 advisories over ten real
   trivy-db ``<eco>::<source>`` buckets, details for a quarter of the IDs)
   with a ``debian 12`` bucket and 200 planted advisories; a CycloneDX SBOM
   of 100,000 npm, golang and cargo components, 2,000 pypi components (the
   host comparator), 500 debian packages with an operating-system component,
   and each planted package at a version inside its vulnerable range and at
   its patched version. ``cli.scan_sbom`` on the card twice with one loaded
   DB, the launch counters set to 0 just before each scan and read just
   after, then with ``device="cpu"``: equal ``Results``, every plant
   reported, no patched plant reported, one ``verscmp`` launch per card scan
   and no bound bytes uploaded by the second. The kernel is then held
   against its plain version on the inputs captured from the first scan's
   dispatch and on distinct bounds, and timed there (phases 2 and 3).
9. fs-vuln: this slice's path. A seeded monorepo tree holding the cve
   SBOM's components as lockfiles (npm in 25 ``package-lock.json`` v3
   files, golang in 30 ``go.mod``, cargo in 10 ``Cargo.lock``, pypi in a
   ``poetry.lock`` and a ``requirements.txt``, each plant at its vulnerable
   and its patched version), a debian 12 root with the 500 ``deb-lib-*``
   packages in ``var/lib/dpkg/status``, 2,000 ``node_modules`` packages
   with licenses and 4 MiB of the seeded text with planted secrets.
   ``cli.scan_fs`` with ``--scanners vuln`` on the card twice with one
   freshly loaded cve DB (launch counters to 0 just before each scan, read
   just after), then on the CPU; then ``vuln,secret,license`` on the card
   and on the CPU. ``Results`` and ``Metadata`` must be equal between card
   and CPU, every plant reported and none at its patched version, every
   planted secret and package license reported, one ``verscmp`` launch per
   card scan and no bound bytes uploaded by the second; the kernel must
   equal its plain version on the first scan's captured dispatch.
9b. incremental: ``scan_fs`` with an ``IncrementalOptions`` and an fs scan
    cache, on a git copy of the fs-vuln tree (2,000 ``node_modules``
    packages, 67 lockfiles, a debian root and 4 MiB of text with secrets,
    about 2,100 units) with eight license texts added to its ``src`` unit,
    with ``vuln,secret,license`` on the card and the fs-vuln phase's loaded
    DB, launch counters to 0 just before each scan and read just after: a
    cold ``--incremental`` scan equal to phase ``fs-vuln``'s full card scan
    beside the eight licenses, every feed and license kernel launched; an
    unchanged ``--since-last`` scan (no unit analyzed, no file read, no feed
    or license kernel launched, one ``verscmp``); a secret planted in
    ``src/module_0.py`` (one unit analyzed, the new finding on its line,
    every other finding as before, and the feed and license kernels
    launched as often as by a full scan of a tree holding ``src`` alone);
    a commit and a ``--since-last`` scan at it, then every mtime touched and
    ``--diff-base HEAD`` (every file keyed from git, no unit analyzed, no
    feed launch); then ``cli.main(["watch", ..., "--watch-count", "1"])`` on
    the same cache (one report, the diff-base scan's filtered ``Results``,
    no feed launch). Printed per scan: seconds, units, file reuse, launches.
10. ladder: the scan ladder on the card, after ``fs-vuln`` and on its tree
    and cve DB, each run through ``cli.main`` with a fresh cache and the
    launch counters set to 0 just before and read just after, 64-row
    batches so the tree makes several: ``fs --scanners secret`` with
    ``--fault-inject device.dispatch@d0:at=2`` (one batch retried),
    ``device.fetch@d0:at=3`` (one retried at the fetch) and
    ``device.dispatch@d0:at=1:error=oom`` (one split), each with the
    unfaulted card scan's ``Results`` and no ``Degraded``; every dispatch
    dead (``device.dispatch:times=-1`` with ``--debug-dir``): with
    ``--device cpu`` the scan degrades to the host engine (exit 0,
    ``"Degraded": true``, the card's ``Results``, one bundle that ``debug``
    renders), while on the card the exhausted ladder raises the fault with
    or without ``--no-host-fallback`` and leaves a terminal bundle whose
    verdict names it; ``fs --scanners secret,license --license-full`` of
    twelve license files with ``device.dispatch@license:at=2:times=-1``
    (on the CPU ``license.degraded`` and the card's findings, on the card
    the fault raised); ``sbom`` of the cve SBOM with
    ``device.dispatch@cve:times=-1`` (on the card the fault raised); an
    encoder that raises (every batch shipped raw, the same ``Results``);
    ``--timeout 1`` on the e2e tree (exit 1). Then the allocator's own
    OOM: a child process scans the e2e tree's 16 MiB subset at full
    batches, then again with its device memory capped
    (``torch.cuda.set_per_process_memory_fraction``) ``OOM_CUT`` under the
    first scan's peak, where a half batch fits and a full one does not:
    ``batch_splits`` >= 1, no degrade, the first scan's ``Results``.
    Printed per run: seconds, the ladder's counters and the kernel
    launches it added. Every other phase's scans go through
    ``unfaulted``: a scan there that retried, split or degraded anything,
    or a report marked ``Degraded``, fails the smoke.
10b. mesh: multi-device dispatch over ``[cuda:0, cuda:0]`` (one card
    twice: no number here is a multi-card number), after ``ladder`` on the
    e2e tree's 16 MiB ``sub16`` subset (the feed phase's) in 128-row
    batches, each scan through
    ``cli.scan_fs`` with scanner options, with the launch counters set to 0
    just before and read just after and a trace context counting
    ``mesh.d<i>.batches``: (a) round-robin (``dispatch="round_robin"``,
    ``devices``) against the single-dispatch card scan and the subset's
    ``--device cpu`` Results, both dispatch indices taking batches, their
    sum equal to the prefilter's launches; (b) the same under
    ``device.dispatch@d1:times=-1``: equal Results, no degrade, the
    breaker gauge ``{device="d1"} 1``; (c) both indices dead: the scan
    raises on the card; (d) a ``data = 2`` mesh: equal Results, no
    compressed batch, two prefilter launches per batch, and
    ``hit_counts_psum`` against the plain matcher's column sums; (e) the
    classifier with its corpus over ``model = 2`` against one shard (equal
    findings), and ``bytes_score.cu`` at the shard widths Ls = 59 (m = 2)
    and Ls = 30 (m = 4) at 4096 and 16384 against its plain version
    (bitwise apart from ``SCORE_RTOL`` on ``full_w``), reassembled against
    m = 1, and timed; (f) the legacy int32 scorer (PyTorch on the card) at
    m = 1 and m = 2 against its CPU version at the six shapes of
    ``tools/legacy_scorer_shapes.py``, timed behind the spin beside its
    bound and ``embedding_bag``'s masked sum.
11. trace: the span layer (``trivy_tpu_torch/obs/``) on the fs-vuln tree
    before it is deleted, with sixteen license files added (its own
    licenses are package metadata, which the classifier does not read).
    ``fs --scanners vuln,secret,license`` through the command line
    (``cli.main``) on the card three times: plain under
    ``torch.profiler`` (CUDA activity only), then with ``--trace-out``,
    ``--metrics-out``, ``--profile-out`` and ``--timeseries-out``, then
    plain without the profiler (the traced scan's cost is its seconds over
    this one's). ``Results`` must be equal, each file must parse, the Chrome
    trace must hold spans of the feeder, the device worker and the confirm
    pool, the stall verdict must name the secret, license and cve
    pipelines, and every span ``tests/test_torch_trace_cli.py`` expects (and
    the CVE join's) must be present. Printed: the seconds of the three
    scans and of the phase, the stall verdict, the host time by stage, and the card's busy
    share measured by the profiler (the kernels' summed durations over the
    plain scan's wall time; a profiler that records no kernel fails the
    phase) beside the share derived from the scan's launches times each
    kernel's ``timing`` ms.
12. formats: every report format of the JAX CLI through ``cli.main`` on a
    cut of the fs-vuln tree (a lockfile of each kind, the debian root, 100
    ``node_modules`` packages, the trace phase's license files, one planted
    secret) plus a lockfile whose packages depend on five planted npm
    packages (no plant in the cut has a dependent) and an AWS key, with the
    cve DB and the secret rules of the plants and of phase misconf.
    ``fs --scanners vuln,secret,license --list-all-pkgs`` once on the
    card with each of ``json``, ``cyclonedx``, ``spdx-json``, ``spdx``,
    ``sarif``, ``github``, ``cosign-vuln``, ``table --dependency-tree`` and
    ``template -t @file`` (launch counters to 0 just before each scan, read
    just after), and each with ``--device cpu`` as ``python -m
    trivy_tpu_torch`` (five at once, beside the card's scans): equal bytes
    apart from the fields derived from the clock (CycloneDX's serial number
    and timestamp, SPDX's namespace and creation time, the snapshot's
    ``scanned``, the report's and cosign's times), each present once.
    ``convert`` of the card's JSON into the eight other formats must give
    the card scans' bytes (the same fields aside); ``sbom`` of the card's
    CycloneDX on the card must report the fs scan's vulnerabilities with
    one ``verscmp`` launch; the dependency tree must name the five planted
    packages and their dependents. Printed: bytes, card, CPU, convert and
    writer seconds per format, the SBOM's components and the launches.
12a. misconf: ``--scanners misconfig`` in the feed's walk (the config
    analyzer, ``trivy_tpu_torch/misconf/``), card against ``--device cpu``:
    (a) Dockerfiles, manifests, YAML and JSON beside secrets and licenses;
    (b) custom Python and Rego checks; (c) a seeded tree of CloudFormation
    stacks and Helm charts beside a Dockerfile and two credentials, printed
    with its seconds, the feed's launches and the ``misconf.helm`` span, and
    ``--compliance docker-cis-1.6.0`` of (a)'s tree; (d) an image's history as a
    Dockerfile; (e) the global flags and small commands; (f) a Terraform
    monorepo of 360 ``.tf`` files (about 2 MiB of HCL) with a plan and two
    ARM templates beside the feed, printed with its seconds, launches and
    ``misconf.terraform`` span (``phase_misconf``).
12b. server: client/server mode on the fs-vuln tree and the cve DB, after
    ``formats``. An in-process ``start_server(device="cuda")`` with the
    loaded DB on a thread (``--max-concurrent-scans 2
    --admission-queue-depth 1``) and ``cli.main``'s ``fs --scanners
    vuln,secret,license --license-full --server`` as the client, beside a
    local card scan of the tree: (a) the client scan's ``Results`` and ``Metadata`` equal
    the local scan's, with the matcher, decompressor and license kernels
    launched by the client and ``verscmp`` by the server (launch counters
    to 0 just before, read just after; the ``kernels`` line's
    ``launches_server``); (b) a warm rescan sends no blob and its server
    uploads no bound bytes; (c) four clients at once on their own lockfile
    subsets, each equal to its serial scan; (d) a burst of raw submits past
    the queue answers 429 or 503 with ``Retry-After``, and ``submit`` then
    ``wait_result`` equals the sync scan; (e) ``python -m trivy_tpu_torch
    server --device cuda --token T`` as a subprocess: a client scan equal
    to (c)'s, a wrong token refused with 401, SIGTERM drains it, exit 0;
    (f) (b)'s ``--trace-out`` holds one trace id with the server's spans
    under the client's ``rpc.scan``, and ``GET /metrics`` parses with
    ``parse_text``; (g) the fleet through the port's coordinator
    (``fleet_leg``, the ``server-fleet`` line): ``cli.main``'s ``--fleet``
    over the phase's server and a second one on the card without admission
    (synchronous shards), launches counted per trace context. (g1) ``fs``
    of the tree in four shards with the telemetry plane at its default
    interval (1.0 s): the local scan's ``Results``, every feed and license
    kernel launched by the replicas' shard scans and one ``verscmp`` by the
    coordinator's fold, and the ``fleet`` block of ``--metrics-out`` naming
    both replicas, scraped, with a headroom in [0, 1]; the other sub-legs
    scan ``secret,license`` without a DB: (g2) a few MiB of the tree over
    one live and one dead replica with the plane at 0.2 s: equal
    ``Results``, no ``Degraded``, the dead replica's breaker open and its
    failed scrapes in the ``fleet`` block; (g3) the subtree over
    two dead replicas: the local fallback launches the feed and license
    kernels in the coordinator, root ``Degraded``, equal ``Results``, and
    with ``--no-host-fallback`` exit 1; (g4) ``image --fleet`` of a
    three-layer archive of the subtree: the local image scan's ``Results``,
    ``ImageID`` and ``DiffIDs``; g3 and g4 run with
    ``--fleet-telemetry-interval 0``. The plan's, the fan-out's and the
    fold's seconds, the coordinator's counters and the replicas' headroom
    and fleet MB/s are printed.
    Printed: the local and client/server scans' seconds and components/s,
    the sheds, the subprocess's start-up seconds, and the shards' and the
    fold's seconds beside the local scan's.
13. image: this slice's path. A seeded docker-save archive of about 64
    MiB of layer bytes (``--image-mib``) in five layers: a debian 12 base
    (the fs-vuln ``var/lib/dpkg/status`` and one planted secret; the
    history marks it as the base image, so its secret must not be
    reported), the fs-vuln lockfiles with their plants, ``node_modules``
    and secrets, the license tree's license files, headers and source
    text with planted secrets, a layer of whiteouts (one removes a file
    with a secret, one a lockfile with a plant, an opaque dir a third
    secret; none may be reported), and a small top layer; the config
    carries an ENV secret. ``cli.scan_image`` with ``vuln,secret,license
    --license-full`` on the card with a fresh layer cache and the loaded
    cve DB (launch counters to 0 just before, read just after): every
    surviving plant reported, none of the removed ones, the ENV secret
    reported, all six kernels launched and ``verscmp`` once. The same scan
    again on the same cache: no layer analyzed, no matcher, decompressor
    or license kernel launched, equal ``Results``. Then an 8 MiB image cut
    from the same layers, on the card and with ``device="cpu"`` (equal
    ``Results`` and ``Metadata``), and its OCI-layout copy with gzip layers
    on the card (``Results`` equal to the docker-save copy's, the artifact
    name in the OS section's target aside). Printed: layer MB/s,
    components/s and the scan's seconds split into walk and analysis
    against detection.
14. sources: the targets that are not archives, on the image phase's
    inputs and the loaded cve DB, each scan with the launch counters set to
    0 just before and read just after. The image's five layers and config
    (gzip level 1) pushed to the in-process registry of
    ``tests/registrytest.py`` with bearer-token auth, under an index of two
    platforms, and ``image <ref> --image-src remote --platform linux/amd64
    --scanners vuln,secret,license --license-full`` through ``cli.main`` on
    a fresh cache: the first archive scan's ``Results`` (the artifact name
    aside), all six kernels launched, ``verscmp`` once; then on the archive
    scan's layer cache: no layer analyzed. Printed: the push and a separate
    pull's seconds, the scan's analysis and detection seconds, layer MB/s
    over the gzip and the tar bytes. The 8 MiB cut from the fake Docker
    daemon of ``tests/daemontest.py`` on a unix socket (``docker://``,
    ``--image-src docker --docker-host unix://...``): the cut's ``Results``,
    no temp archive left. The cut plus a top layer with a planted secret and
    a vulnerable lockfile, scanned with ``--diff-base`` the cut: only the new
    layer walked, every other seeded from the base, a plain scan's
    ``Results``, both plants reported. A git repository of the checkout's
    code: ``repo file://... --branch`` equals ``fs`` of the tree (names
    aside). ``mkfs.ext4 -d`` of the fs-vuln tree with the trace phase's
    license files: ``vm`` on the card equals the CPU, every plant, secret
    and license reported, all six kernels launched; the rescan walks no
    file and launches no feed or license kernel. The fakes are loaded by
    path (``load_fake``); ``DOCKER_HOST`` is unset, so no daemon of the
    machine is reached.
15. kernels: every ported kernel with its launches on the main path, its
    agreement with the plain version (bitwise, or within ``SCORE_RTOL`` for
    the scorer's ``full_w``) and its times, with its launches in the
    ``formats`` phase's card scans (``launches_formats``), in the ``image``
    phase's first scan (``launches_image``), in the ``sources`` phase's
    registry scan (``launches_registry``), in the ``ladder`` phase's runs
    (``launches_ladder``), in the ``server`` phase's client/server scan
    (``launches_server``) and in its fleet leg by sub-leg and role
    (``launches_fleet``: the replicas, the fold, the local fallback), in
    the ``incremental`` phase's cold scan
    (``launches_incremental``) and in its scans of an unchanged tree
    (``launches_incremental_rescans``, all zero but ``verscmp``'s), and in
    the ``mesh`` phase's round-robin and mesh runs with their batches by
    dispatch index; the scorer's times at the shard widths.

The line before the last is the card's name and power limit as nvidia-smi
prints them; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA card, or outside a checkout of the repository, the script exits with a
non-zero code and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gzip
import importlib.util
import io
import json
import os
import random
import re
import runpy
import shutil
import signal
import socket
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from trivy_tpu_torch import cli, faults
from trivy_tpu_torch import report as report_pkg
from trivy_tpu_torch.artifact.image import ImageSourceOption, _ImageArchive
from trivy_tpu_torch.cache import MemoryCache
from trivy_tpu_torch.db import VulnDB
from trivy_tpu_torch.detector import library
from trivy_tpu_torch.device import card_info
from trivy_tpu_torch.fanal.image_registry import RegistryImage
from trivy_tpu_torch.licensing.classify import DEVICE_MIN_TEXTS, LicenseClassifier
from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS
from trivy_tpu_torch.licensing.fused import get_gate_fn
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import recorder
from trivy_tpu_torch.obs.stall import ORDER as STALL_ORDER
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops.bytes_gate import (
    SHINGLE_BITS, SHINGLE_MIX, SHINGLE_P2, bytes_gate_plain, pack_windows,
)
from trivy_tpu_torch.ops.bytes_gate_cuda import SCREEN4_BITS, SCREEN8_BITS, fold
from trivy_tpu_torch.ops.bytes_score import bytes_score_plain, credited_keys, effective_cap
from trivy_tpu_torch.ops.bytes_score_cuda import (
    CLUSTER_SIZES, SLICE_MAX, CudaBytesScorer, cluster_size,
)
from trivy_tpu_torch.ops.decompress import build_decompress_fn, decompress_plain
from trivy_tpu_torch.ops.gram_gate import (
    LANE_ANCHOR, LANE_GRAM, LANE_NONASCII, M32, gram_gate_plain, gram_keys, lut_image, mul32,
    screen_bits, screen_pass, word_hashes,
)
from trivy_tpu_torch.ops.ngram_score import BYTES_WIDTHS, PAD_KEY, DeviceBytesScorer
from trivy_tpu_torch.ops.match import match_plain, match_tables
from trivy_tpu_torch.ops.match_cuda import (
    LAUNCH_SHAPES, LAUNCHES, SCREEN_BYTES, build_match_fn_cuda, literals, pack_tables,
)
from trivy_tpu_torch.ops import verscmp, verscmp_cuda
from trivy_tpu_torch.ops.prefilter import build_prefilter_fn
from trivy_tpu_torch.ops.verscmp import check_ops_gather_plain, check_ops_plain, lexcmp_plain
from trivy_tpu_torch.ops.verscmp_cuda import check_ops, check_ops_gather, lexcmp
from trivy_tpu_torch.secret.compress import MODE_PACK7, MODE_RAW, MODE_TOKEN, SlabCodec
from trivy_tpu_torch.secret.device_compile import compile_rules
from trivy_tpu_torch.secret.engine import ScannerConfig, SecretScanner
from trivy_tpu_torch.secret import scanner as secret_scanner
from trivy_tpu_torch.secret.scanner import BATCH, BUCKET_RUNGS, CHUNK_LEN
from trivy_tpu_torch.types import Report

REPO = Path(__file__).resolve().parent
# one sample token per built-in rule, and custom rulesets with a sample per
# rule, shared with the tests
SAMPLES: dict[str, str] = runpy.run_path(str(REPO / "tests" / "secret_samples.py"))["SAMPLES"]
CUSTOM = runpy.run_path(str(REPO / "tests" / "test_torch_rulesets.py"))
# docker-save and OCI-layout archive writers, shared with the tests
IMAGES = runpy.run_path(str(REPO / "tests" / "imagetest.py"))
# the seeded Terraform monorepo of phase misconf's leg (f), shared with the tests
TFTREE = runpy.run_path(str(REPO / "tests" / "tftree.py"))
# the seeded CloudFormation and Helm tree of phase misconf's leg (c)
IACTREE = runpy.run_path(str(REPO / "tests" / "iactree.py"))
# the custom rulesets checked on the card: one widens the tables past the
# built-ins' shapes, one goes below the screen's width (1- and 2-byte
# keywords, a 3-byte anchor)
CHECK_RULESETS = ("edges", "short")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SPIN_CYCLES = 200_000_000  # about 0.1 s of the card's clock, ahead of each timed round
FLUSH_BYTES = 256 << 20  # written before each cold launch: five times the card's 50 MB L2
KERNEL_SOURCE = "trivy_tpu_torch/ops/csrc/match.cu"
REPLACES = "trivy_tpu/ops/match_pallas.py:109"
DECOMPRESS_SOURCE = "trivy_tpu_torch/ops/csrc/decompress.cu"
DECOMPRESS_REPLACES = "trivy_tpu/ops/decompress.py:47"
# the license kernels: (launch counter, source, the JAX computation replaced)
LICENSE_KERNELS = {
    "gram_gate": ("trivy_tpu_torch/ops/csrc/gram_gate.cu", "trivy_tpu/ops/gram_gate.py:73"),
    "bytes_gate": ("trivy_tpu_torch/ops/csrc/bytes_gate.cu", "trivy_tpu/ops/ngram_score.py:696"),
    "bytes_score": ("trivy_tpu_torch/ops/csrc/bytes_score.cu",
                    "trivy_tpu/ops/ngram_score.py:754"),
}
VERSCMP_SOURCE = "trivy_tpu_torch/ops/csrc/verscmp.cu"
VERSCMP_REPLACES = "trivy_tpu/ops/verscmp.py:37"
# csrc/<name>.cu, built at once
LIBRARIES = ("match", "decompress", *LICENSE_KERNELS, "verscmp")
# the launch counters of the kernels an image's layer analysis runs (every
# kernel but verscmp, which detection runs)
IMAGE_KERNELS = ("prefilter", "anchored", "decompress", *LICENSE_KERNELS)
SCORE_RTOL = 1e-5  # the scorer's full_w against its plain version (float32 sums)
GATHER_WIDTHS = (1024, 16384, 49152)  # rungs where the scorer is also timed on gathered rows
SHORT_BATCH = 8  # live rows of the short check batch
# MiB of the image cut that the image phase scans on the card, on the CPU and
# as an OCI layout, and the sources phase serves from the daemon and derives
# from: small, as the CPU scan of it sets much of the phase's time
IMAGE_CUT_MIB = 8
# license files in the image's content layer: each text in each form at each
# width rung once (the license phase's tree cycles through them four times)
IMAGE_LICENSE_FILES = 3 * len(FULL_TEXTS) * (len(BYTES_WIDTHS) + 1)

# words of the generated source text; some are rule keywords, as in real code
CODE_WORDS = (
    "def return import self config value if else for in while class None True "
    "False print len range https://example.com/api aws_region api_key token "
    "os.environ.get client request response json data user name id path file "
    "open read write close error raise except try with as from global lambda"
).split()


# a phase line's "t": seconds since the script started, to read where a
# run's time went against the time limit
T_START = time.perf_counter()


def log(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def text_base(rng: random.Random, n_words: int) -> bytes:
    """Seeded source-like text: code words and random identifiers, eight to
    a line."""
    letters = "abcdefghijklmnopqrstuvwxyz_"
    vocab = CODE_WORDS + [
        "".join(rng.choice(letters) for _ in range(rng.randint(2, 10))) for _ in range(3000)
    ]
    words = rng.choices(vocab, k=n_words)
    lines = [" ".join(words[i : i + 8]) for i in range(0, n_words, 8)]
    return ("\n".join(lines) + "\n").encode()


def sample_rows(rng: np.random.Generator, base: np.ndarray, samples: list[str],
                rows: int, width: int, overlap: int) -> np.ndarray:
    """Rows of random printable bytes, random bytes 0-255 and source text,
    with samples planted at offset 0, mid-row, straddling the start of the
    row overlap and ending at the last byte."""
    out = np.empty((rows, width), dtype=np.uint8)
    kind = np.arange(rows) % 3
    out[kind == 0] = rng.integers(32, 127, (int((kind == 0).sum()), width), dtype=np.uint8)
    out[kind == 1] = rng.integers(0, 256, (int((kind == 1).sum()), width), dtype=np.uint8)
    offs = rng.integers(0, len(base) - width, int((kind == 2).sum()))
    out[kind == 2] = base[offs[:, None] + np.arange(width)]
    for i in range(rows):
        for k in range(1 + i % 3):
            enc = np.frombuffer(samples[(i * 3 + k) % len(samples)].encode("latin-1"),
                                dtype=np.uint8)[:width]
            n = len(enc)
            pos = [0, width // 2, width - overlap - n // 2, width - n][(i + k) % 4]
            out[i, pos : pos + n] = enc
    return out


def time_cuda(fn, inputs: list, reps: int = 1, rounds: int = 3) -> tuple[float, list, float]:
    """Device ms per call of ``fn`` over ``inputs`` (CUDA events, after one
    warm-up pass): the median of ``rounds`` rounds, the rounds themselves,
    and the host's microseconds to enqueue one call. Before each round the
    card spins for about 0.1 s (``SPIN_CYCLES``) while the host enqueues
    the whole round, so the events time the card's work and not gaps left
    by the host; ``host_us`` times ``reps * len(inputs)`` calls must stay
    well under the spin."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times, host = [], []
    for _ in range(rounds):
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            for x in inputs:
                fn(x)
        host.append(time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (reps * len(inputs)))
    return float(np.median(times)), times, min(host) / (reps * len(inputs)) * 1e6


def time_cold(fn, inputs: list, reps: int = 25) -> tuple[float, list]:
    """Device ms per call of ``fn`` with a cold L2: before each call a
    ``FLUSH_BYTES`` buffer is written, and CUDA events time the call alone;
    the median of ``reps`` calls on each input (after one warm-up pass),
    all queued behind a device spin, and the times themselves."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    events = []
    torch.cuda._sleep(SPIN_CYCLES)
    for k in range(reps):
        for x in inputs:
            flush.fill_(k)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            end.record()
            events.append((start, end))
    torch.cuda.synchronize()
    times = [start.elapsed_time(end) for start, end in events]
    return float(np.median(times)), times


GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType


def work_per_call(fn, inputs: list) -> dict:
    """The work one call of ``fn`` puts on the stream: the nodes of a CUDA
    graph captured around a call on each of ``inputs`` (after a warm-up
    call on the capture stream, so that the wrapper's one-time set-up is
    not counted), per call, in all (``per_call``) and by type (kernels,
    copies, fills). Fails where this PyTorch cannot hand out the graph."""
    import ctypes

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn(inputs[0])
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        raise AssertionError(f"cannot read a captured graph's nodes: {e}") from e
    with torch.cuda.graph(graph, stream=stream):
        for x in inputs:
            fn(x)
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    by_type: dict[str, float] = {}
    for node in nodes[: n.value]:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        name = GRAPH_NODE_TYPES.get(kind.value, "other")
        by_type[name] = by_type.get(name, 0) + 1 / len(inputs)
    del graph
    torch.cuda.synchronize()
    return {"per_call": n.value / len(inputs), "by_type": by_type}


def phase_check(rulesets: list, base, rng) -> dict:
    """Kernel against match_plain on the card, both uses, every ruleset:
    ``rulesets`` holds (compiled rules, samples, rows)."""
    batches = [
        torch.from_numpy(sample_rows(rng, base, samples, rows, CHUNK_LEN,
                                     max(64, compiled.span + 1))).cuda()
        for compiled, samples, rows in rulesets
    ]
    verdict = {}
    for use, build in (
        ("prefilter", lambda c: build_prefilter_fn(c, CHUNK_LEN)),
        ("anchored", lambda c: build_match_fn_cuda(c, CHUNK_LEN, include_keywords=False)),
    ):
        err, equal, hits = 0, True, []
        for (compiled, *_), rows in zip(rulesets, batches):
            fn = build(compiled)
            for n in (rows.shape[0], 8):  # the full batch and a short one
                got = fn(rows[:n])
                want = match_plain(fn.tables, rows[:n])
                torch.cuda.synchronize()
                equal &= torch.equal(got, want)
                err = max(err, int((got.int() - want.int()).abs().max()))
                hits.append(int(want.sum()))
        verdict[use] = {"equal": equal, "max_abs_err": err, "hits": hits}
        log({"phase": "check", "use": use, **verdict[use]})
        check(equal, f"{use}: kernel disagrees with match_plain")
        check(min(hits) > 0, f"{use}: a check batch produced no hits")
    return verdict


def resident_batches(dev_base: torch.Tensor, rng, rows: int, width: int, n: int) -> list:
    """``n`` [rows, width] batches of source text cut from ``dev_base`` at
    seeded offsets, resident on the card."""
    cols = torch.arange(width, device=dev_base.device)
    return [
        dev_base[torch.from_numpy(rng.integers(0, len(dev_base) - width, rows))
                 .to(dev_base.device)[:, None] + cols].contiguous()
        for _ in range(n)
    ]


def screen_pass_share(tables, data: np.ndarray) -> float:
    """Share of the positions of ``data`` where some bucket passes the
    kernel's screen (computed on the host from the packed tables)."""
    screen = pack_tables(tables)["screen"]
    padded = np.concatenate([data, np.zeros(SCREEN_BYTES, np.uint8)])
    cand = np.full(len(data), ~np.uint64(0))
    for j in range(SCREEN_BYTES):
        cand &= screen[j][padded[j : j + len(data)]]
    return float((cand != 0).mean())


def dense_text(rng, tables, n: int) -> np.ndarray:
    """``n`` bytes made of the first bytes (up to the screen's width) of
    the literals of ``tables``, drawn in seeded order: a literal's head
    starts every few bytes and passes the screen there, so the verify step
    runs far more often than on any text."""
    heads = [lit.lit[:SCREEN_BYTES] for lit in literals(tables)]
    parts = [heads[i] for i in rng.integers(0, len(heads), n // 2)]
    return np.frombuffer(b"".join(parts)[:n], dtype=np.uint8)


def repo_source() -> np.ndarray:
    """Every ``*.py`` file under the checkout's ``trivy_tpu/``, as bytes."""
    return np.frombuffer(b"".join(
        p.read_bytes() for p in sorted((REPO / "trivy_tpu").rglob("*.py"))), dtype=np.uint8)


def phase_timing(compiled, base: np.ndarray, rng, card: str) -> dict:
    """Each use over ~1 GiB of resident [BATCH, CHUNK_LEN] batches of each
    input (seeded text, repo source, random bytes, keyword-dense text),
    match_plain at the same shape on a few seeded-text batches; then the
    kernels at other row lengths with the same bytes per batch, and the
    pinned host-to-device copy of one batch."""
    dev_base = torch.from_numpy(base.copy()).cuda()
    source_np = repo_source()
    dev_source = torch.from_numpy(source_np.copy()).cuda()
    n_batches = (1 << 30) // (BATCH * CHUNK_LEN)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(1 << 31)))
    R = compiled.num_rules
    nbytes = BATCH * CHUNK_LEN + BATCH * R  # rows read once, hit mask written once
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {}
    for use, fn in (("prefilter", build_prefilter_fn(compiled, CHUNK_LEN)),
                    ("anchored", build_match_fn_cuda(compiled, CHUNK_LEN, include_keywords=False))):
        dense_np = dense_text(rng, fn.tables, 1 << 20)
        dense = torch.from_numpy(dense_np.copy()).cuda()
        # the random batches are drawn on the card; their share is taken on
        # host bytes of the same distribution
        share = {name: screen_pass_share(fn.tables, data) for name, data in (
            ("text", base), ("source", source_np),
            ("random", rng.integers(0, 256, 1 << 20, dtype=np.uint8)),
            ("dense", dense_np))}
        inputs = {
            "text": lambda: resident_batches(dev_base, rng, BATCH, CHUNK_LEN, n_batches),
            "source": lambda: resident_batches(dev_source, rng, BATCH, CHUNK_LEN, n_batches),
            "random": lambda: [
                torch.randint(0, 256, (BATCH, CHUNK_LEN), dtype=torch.uint8, device="cuda",
                              generator=gen) for _ in range(n_batches)],
            "dense": lambda: resident_batches(dense, rng, BATCH, CHUNK_LEN, n_batches),
        }
        res = {"shape": [BATCH, CHUNK_LEN], "batches": n_batches, "bound_ms": bound_ms,
               "bound_by": "bytes", "card": card}
        for name, make in inputs.items():
            batches = make()
            ms, rounds, host_us = time_cuda(fn, batches, reps=2)
            key = "" if name == "text" else f"_{name}"
            res[f"ms{key}"] = ms
            res[f"ms_rounds{key}"] = rounds
            res[f"GBps{key}"] = BATCH * CHUNK_LEN / ms / 1e6
            res[f"bound_share{key}"] = bound_ms / ms
            res[f"screen_pass_share{key}"] = share[name]
            if name == "text":
                res["host_us_per_call"] = host_us
                res["plain_ms"] = time_cuda(
                    lambda t, f=fn: match_plain(f.tables, t), batches[:3], rounds=1)[0]
            del batches
        out[use] = res
        log({"phase": "timing", "use": use, **res})
    slab = torch.zeros((BATCH, CHUNK_LEN), dtype=torch.uint8, pin_memory=True)
    dst = torch.empty_like(slab, device="cuda")
    copy_ms = time_cuda(lambda t: dst.copy_(t, non_blocking=True), [slab] * 20)[0]
    for width in (4096, 8192, 16384, 32768):
        rows = BATCH * CHUNK_LEN // width
        xs = resident_batches(dev_base, rng, rows, width, 16)
        log({"phase": "shape", "shape": [rows, width], "h2d_copy_ms": copy_ms, **{
            f"{use}_ms": time_cuda(fn, xs, reps=2)[0] for use, fn in (
                ("prefilter", build_prefilter_fn(compiled, width)),
                ("anchored", build_match_fn_cuda(compiled, width, include_keywords=False)))
        }})
        del xs
    torch.cuda.empty_cache()
    return out


def kind_rows(kind: str, rng, base: np.ndarray, rows: int) -> np.ndarray:
    """``[rows, CHUNK_LEN]`` rows of one kind cut from ``base`` at seeded
    offsets (``text`` and ``source``), uniform random bytes (RAW rows),
    zeros (TOKEN rows of runs), or a mix of text, random printable, zero and
    random-byte rows."""
    C = CHUNK_LEN
    if kind == "random":
        return rng.integers(0, 256, (rows, C), dtype=np.uint8)
    if kind == "zero":
        return np.zeros((rows, C), np.uint8)
    out = base[rng.integers(0, len(base) - C, rows)[:, None] + np.arange(C)]
    if kind == "mix":
        out[1::4] = rng.integers(32, 127, (len(out[1::4]), C), dtype=np.uint8)
        out[2::4] = 0
        out[3::4] = rng.integers(0, 256, (len(out[3::4]), C), dtype=np.uint8)
    return out


def encode(codec: SlabCodec, rows: np.ndarray, rows_pad: int):
    """The codec's frame of ``rows`` padded to ``rows_pad`` rows, with a
    wire buffer exactly as long as its streams (the last stream ends at the
    buffer's last byte), and the host's seconds for ``plan`` + ``emit``."""
    t0 = time.perf_counter()
    plan = codec.plan(rows)
    out = np.empty(plan.total(), np.uint8)
    cs = codec.emit(plan, rows_pad, plan.total(), out)
    return cs, time.perf_counter() - t0


def edge_frame(C: int) -> tuple:
    """Streams at the buffer's edges: a short RAW stream, one ending at the
    last byte, one starting before the buffer, one running past its end, a
    TOKEN stream crossing C, a mode byte of 3, clen 0 and clen > C."""
    rng = np.random.default_rng(C)
    W = 3 * C
    buf = rng.integers(0, 256, W, dtype=np.uint8)
    buf[:C] = 0x81  # runs of 8 spaces: a TOKEN stream of C bytes expands past C
    offs = np.array([C, W - 40, -5, W - 3, 0, C, 0, C], np.int32)
    clen = np.array([5, 40, C, 10, C, C, 0, 2 * C], np.int32)
    mode = np.array([MODE_RAW, MODE_RAW, MODE_RAW, MODE_PACK7, MODE_TOKEN, 3, MODE_TOKEN,
                     MODE_RAW], np.uint8)
    return buf, offs, clen, mode


def odd_frame(C: int, rng) -> tuple:
    """A wire buffer whose length is no multiple of 16, with 64 streams at
    seeded offsets (every shift mod 16) in every mode, and streams that
    start before the buffer, end past it, lie wholly past it, clen 0 and
    clen > C."""
    W = 5 * C + 13
    buf = rng.choice(np.array([0x80, 0x81, 0x88, 0x20, ord("a"), 0, 0xFF], np.uint8), W)
    B = 64
    offs = np.r_[rng.integers(0, W - C, B - 6), [-9, -C - 3, W - 5, W + 7, 3, W - C]]
    clen = np.r_[rng.integers(1, C + 1, B - 6), [C, C, 40, 12, 0, 2 * C]]
    return (buf, offs.astype(np.int32), clen.astype(np.int32),
            (np.arange(B) % 4).astype(np.uint8))


def phase_check_decompress(base: np.ndarray, rng) -> dict:
    """The decompress kernel against decompress_plain on the card: frames of
    seeded text, the repo's source, random-byte, zero and mixed rows at
    [BATCH, CHUNK_LEN] and at
    SHORT_BATCH live rows padded to the smallest bucket, and the edge
    frame. The decoded rows must also equal the rows encoded."""
    codec = SlabCodec(CHUNK_LEN)
    fn = build_decompress_fn(CHUNK_LEN, codec.tab_bytes, codec.tab_len, "cuda")
    small = BATCH >> (BUCKET_RUNGS - 1)
    err, equal, cases = 0, True, []

    def compare(arrays, name: str, rows=None) -> None:
        nonlocal err, equal
        parts = [torch.from_numpy(a).cuda() for a in arrays]
        got = fn(*parts)
        want = decompress_plain(fn.tab_bytes, fn.tab_len, *parts, CHUNK_LEN)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        case = {"case": name, "rows": int(got.shape[0]), "equal": same,
                "max_abs_err": int((got.int() - want.int()).abs().max())}
        if rows is not None:
            case["decoded_equal_source"] = (
                torch.equal(got[: len(rows)].cpu(), torch.from_numpy(rows))
                and not bool(got[len(rows):].any()))
            case["modes"] = np.bincount(arrays[3][: len(rows)], minlength=3).tolist()
            check(case["decoded_equal_source"], f"decompress {name}: rows differ from the source")
        err = max(err, case["max_abs_err"])
        equal &= same
        cases.append(case)

    source = repo_source()
    for kind in ("text", "source", "random", "zero", "mix"):
        for live, pad in ((BATCH, BATCH), (SHORT_BATCH, small)):
            rows = kind_rows(kind, rng, source if kind == "source" else base, live)
            compare(encode(codec, rows, pad)[0].arrays(), f"{kind}-{live}", rows)
    compare(edge_frame(CHUNK_LEN), "edges")
    compare(odd_frame(CHUNK_LEN, rng), "odd-length wire")
    # the mixed frame from a wire buffer one byte off 16-byte alignment
    frame = encode(codec, kind_rows("mix", rng, base, BATCH), BATCH)[0].arrays()
    wire = torch.zeros(len(frame[0]) + 1, dtype=torch.uint8, device="cuda")
    wire[1:] = torch.from_numpy(frame[0]).cuda()
    got = fn(wire[1:], *(torch.from_numpy(a).cuda() for a in frame[1:]))
    want = decompress_plain(fn.tab_bytes, fn.tab_len, *(torch.from_numpy(a).cuda() for a in frame),
                            CHUNK_LEN)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    cases.append({"case": "mix, misaligned wire", "rows": BATCH, "equal": same})
    equal &= same
    log({"phase": "check", "use": "decompress", "equal": equal, "max_abs_err": err,
         "cases": cases})
    check(equal, "decompress kernel disagrees with decompress_plain")
    return {"equal": equal, "max_abs_err": err}


def phase_timing_decompress(base: np.ndarray, rng, card: str) -> dict:
    """The decompress kernel over four distinct [BATCH, CHUNK_LEN] frames of
    seeded text (PACK7 rows), of the repo's source (RAW and TOKEN rows) and
    of mixed rows (about 120 MB of wire and rows each, past the 50 MB L2),
    timed as the matcher is; its bound from the frames' actual
    wire bytes (payload and framing read once, the tables read once, the
    rows written once); the work one wrapper call puts on the stream; the plain
    version's time; the host's encode time per batch; the pinned copy of a
    frame's wire beside the raw slab's."""
    codec = SlabCodec(CHUNK_LEN)
    fn = build_decompress_fn(CHUNK_LEN, codec.tab_bytes, codec.tab_len, "cuda")
    raw = torch.zeros((BATCH, CHUNK_LEN), dtype=torch.uint8, pin_memory=True)
    raw_d = torch.empty_like(raw, device="cuda")
    raw_ms = time_cuda(lambda t: raw_d.copy_(t, non_blocking=True), [raw] * 20)[0]
    out = {}
    source = repo_source()
    for kind in ("text", "source", "mix"):
        frames, enc_s = [], []
        for _ in range(4):
            rows = kind_rows(kind, rng, source if kind == "source" else base, BATCH)
            cs, sec = encode(codec, rows, BATCH)
            frames.append(cs)
            enc_s.append(sec)
        dev = [tuple(torch.from_numpy(a).cuda() for a in cs.arrays()) for cs in frames]
        ms, rounds, host_us = time_cuda(lambda f: fn(*f), dev * 4, reps=4)
        wire = float(np.mean([cs.wire_bytes + cs.frame_bytes() for cs in frames]))
        tables = codec.tab_bytes.nbytes + codec.tab_len.nbytes
        bound_ms = (wire + tables + BATCH * CHUNK_LEN) / HBM_BYTES_PER_S * 1e3
        plain_ms = time_cuda(lambda f: decompress_plain(fn.tab_bytes, fn.tab_len, *f, CHUNK_LEN),
                             dev[:2], rounds=1)[0]
        wire_h = torch.from_numpy(frames[0].buf).pin_memory()
        wire_d = torch.empty_like(wire_h, device="cuda")
        wire_ms = time_cuda(lambda t: wire_d.copy_(t, non_blocking=True), [wire_h] * 20)[0]
        res = {
            "shape": [BATCH, CHUNK_LEN], "frames": len(frames), "ms": ms, "ms_rounds": rounds,
            "host_us_per_call": host_us,
            "launches_per_call": work_per_call(lambda f: fn(*f), dev[:2]),
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "bound_share": bound_ms / ms, "wire_bytes": wire,
            "wire_ratio": wire / (BATCH * CHUNK_LEN),
            "modes": np.bincount(frames[0].mode, minlength=3).tolist(),
            "encode_ms": float(np.median(enc_s)) * 1e3, "h2d_wire_ms": wire_ms,
            "h2d_raw_ms": raw_ms, "card": card,
        }
        out[kind] = res
        log({"phase": "timing", "use": "decompress", "input": kind, **res})
        del dev
    torch.cuda.empty_cache()
    return out


def license_text(rng: random.Random, base: bytes, key: str, form: int, size: int) -> bytes:
    """The full text of ``key`` raw (form 0), re-wrapped at eleven words a
    line (1) or with CRLF line ends (2), followed by whole lines of source
    text up to about ``size`` bytes."""
    t = FULL_TEXTS[key]
    if form == 1:
        words = t.split(" ")
        t = "\n".join(" ".join(words[i : i + 11]) for i in range(0, len(words), 11))
    elif form == 2:
        t = t.replace(". ", ".\r\n")
    body = t.encode() + b"\n"
    if size > len(body) + 64:
        off = rng.randrange(0, len(base) - size)
        fill = base[off : off + size - len(body)]
        body += fill[: fill.rfind(b"\n") + 1]
    return body


def license_rows(rng: random.Random, base: bytes, width: int, n: int) -> np.ndarray:
    """``[n, width]`` text rows as the classifier packs them (each text
    shorter than the row, zero tail): license texts in all three forms at
    seeded sizes, source text, and first the row whose repeated short words
    give more grams than the scorer's cap while its distinct grams fit."""
    keys = sorted(FULL_TEXTS)
    rows = np.zeros((n, width), np.uint8)
    for i in range(n):
        size = rng.randrange(width // 4, width)
        if i == 0:
            body = (" a b" * 500 + "\n" + FULL_TEXTS["MIT"]).encode()
        elif i % 4 == 3:
            off = rng.randrange(0, len(base) - size)
            body = base[off : off + size]
        else:
            body = license_text(rng, base, keys[i % len(keys)], i % 3, size)
        body = body[: width - 1]
        rows[i, : len(body)] = np.frombuffer(body, np.uint8)
    return rows


def gate_rows(rng: random.Random, base_np: np.ndarray, rows: int) -> np.ndarray:
    """``[rows, CHUNK_LEN]`` rows of seeded source text; every third row
    carries a license text at a seeded offset, every fifth some non-ASCII
    bytes."""
    keys = sorted(FULL_TEXTS)
    out = base_np[np.asarray([rng.randrange(0, len(base_np) - CHUNK_LEN) for _ in range(rows)])
                  [:, None] + np.arange(CHUNK_LEN)]
    for i in range(0, rows, 3):
        t = license_text(rng, b"", keys[i % len(keys)], i % 3, 0)[:CHUNK_LEN // 2]
        pos = rng.randrange(0, CHUNK_LEN - len(t))
        out[i, pos : pos + len(t)] = np.frombuffer(t, np.uint8)
    for i in range(1, rows, 5):
        pos = rng.randrange(0, CHUNK_LEN - 8)
        out[i, pos : pos + 8] = 0xE9
    return out


def scorer_rows(rng: random.Random, base: bytes, width: int, n: int) -> np.ndarray:
    """``license_rows`` with the scorer's edge rows after the over-cap row:
    a row with no words, one word over the whole row (it spans every
    slice), a word across every possible slice end (every 16 bytes), and
    one gram key repeated ~2,000 times (it overfills a bucket, which then
    spills to the device scratch)."""
    rows = license_rows(rng, base, width, n)
    edge = bytearray(b" " * (width - 1))
    for e in range(16, width - 2, 16):
        edge[e - 2 : e + 2] = b"abcd"
    for i, body in enumerate((b"", b"w" * (width - 1), bytes(edge),
                              (b" a" * 2000)[: width - 1]), start=1):
        if i < n:
            rows[i] = 0
            rows[i, : len(body)] = np.frombuffer(body, np.uint8)
    return rows


def cluster_choices(width: int) -> tuple:
    """The cluster sizes the scorer is checked and timed at, at ``width``:
    every size whose slices hold at most 2 * SLICE_MAX bytes (the launch
    policy's choice among them)."""
    return tuple(s for s in CLUSTER_SIZES if -(-width // s) <= 2 * SLICE_MAX)


def screen_share(gate, x: torch.Tensor) -> dict:
    """The prescreen on the gram keys of ``x`` (computed on the host from
    the plain helpers): valid keys, the share that passes the screen, and
    the share that is a gate key."""
    starts, H = word_hashes(lut_image(x.cpu(), gate.lut.cpu()), gate.p1, gate.p2)
    key, valid = gram_keys(starts, H, gate.hash_p, gate.ngram)
    k = key[valid].numpy().astype(np.uint32)
    g32 = gate.gate.cpu().numpy().astype(np.uint32)
    return {"gram_keys": int(k.size),
            "screen_pass_share": float(screen_pass(screen_bits(g32), k).mean()) if k.size else 0.0,
            "gate_key_share": float(np.isin(k, g32).mean()) if k.size else 0.0}


def gate_inputs(rng: random.Random, base: bytes, base_np: np.ndarray, n_seeded: int) -> dict:
    """[BATCH, CHUNK_LEN] gate batches on the card: ``n_seeded`` of seeded
    source text with planted licenses (``gate_rows``), one of license text
    (``license_rows``: the prescreen's hits), one of uniform random bytes."""
    out = {f"seeded{i}": torch.from_numpy(gate_rows(rng, base_np, BATCH)).cuda()
           for i in range(n_seeded)}
    out["license"] = torch.from_numpy(license_rows(rng, base, CHUNK_LEN, BATCH)).cuda()
    out["random"] = torch.from_numpy(np.random.default_rng(rng.randrange(1 << 30)).integers(
        0, 256, (BATCH, CHUNK_LEN), dtype=np.uint8)).cuda()
    return out


def phase_check_license(base: bytes, base_np: np.ndarray, seed: int) -> dict:
    """The three license kernels against their plain versions on the card,
    with the classifier's tables: the gram gate (its three lanes) on
    [BATCH, CHUNK_LEN] batches of seeded text, license text and random
    bytes; the shingle gate at every rung; the scorer at every rung and
    every cluster size its launch policy can choose there, on the full
    dispatch and on batches of 8, 16 and 64 rows gathered as ``take_rows``
    gathers flagged rows."""
    rng = random.Random(seed + 3)
    gate = get_gate_fn(CHUNK_LEN, "cuda")
    scorer = LicenseClassifier(device="cuda")._device_scorer()
    g, sc = scorer._gate, scorer._score
    out = {"gram_gate": {"equal": True, "max_abs_err": 0}}
    for kind, x in gate_inputs(rng, base, base_np, 1).items():
        got = gate(x)
        want = gram_gate_plain(x, gate.lut, gate.gate, gate.anchor, gate.p1, gate.p2,
                               gate.hash_p, gate.block, gate.ngram)
        torch.cuda.synchronize()
        res = {"equal": torch.equal(got, want),
               "max_abs_err": int((got.int() - want.int()).abs().max()),
               "rows_flagged": int((want != 0).any(dim=1).sum()),
               "blocks_flagged": int((want != 0).sum()),
               **{f"rows_{name}": int((want & bit).any(dim=1).sum()) for name, bit in (
                   ("gram", LANE_GRAM), ("anchor", LANE_ANCHOR), ("nonascii", LANE_NONASCII))},
               **screen_share(gate, x)}
        log({"phase": "check", "use": "gram_gate", "input": kind, "shape": list(x.shape), **res})
        out["gram_gate"]["equal"] &= res["equal"]
        out["gram_gate"]["max_abs_err"] = max(out["gram_gate"]["max_abs_err"], res["max_abs_err"])
        check(res["equal"], f"gram gate kernel disagrees with gram_gate_plain on {kind} rows")
        if kind.startswith("seeded"):
            check(0 < res["rows_flagged"] < BATCH, "gram gate check flagged no row or all")
    out["bytes_gate"] = {"equal": True, "max_abs_err": 0}
    # uneven shapes: rows straddling and spanning tiles, more tiles than
    # the card has SMs (256 and 384), rows one byte off 16-byte alignment;
    # each twice (the last block's ticket must be back at 0)
    for R, width, offset in ((3, 1024, 0), (5, 49152, 0), (7, 1536, 0), (9, 5120, 0),
                             (64, 8192, 1), (33, 2048, 1), (2048, 1024, 0), (64, 49152, 0)):
        x = torch.from_numpy(scorer_rows(rng, base, width, R))
        flat = torch.zeros(R * width + offset, dtype=torch.uint8, device="cuda")
        flat[offset:] = x.reshape(-1).cuda()
        xr = flat[offset:].view(R, width)
        want = bytes_gate_plain(xr, g.lut, g.bloom8, g.bloom4)
        first, again = g(xr), g(xr)
        torch.cuda.synchronize()
        same = all(torch.equal(a, w) and torch.equal(b, w) for a, b, w in zip(first, again, want))
        out["bytes_gate"]["equal"] &= same
        log({"phase": "check", "use": "bytes_gate", "shape": [R, width],
             "rows_aligned": offset == 0, "equal": same, "calls": 2})
        check(same, f"bytes gate kernel disagrees with bytes_gate_plain at {[R, width]}")
    out["bytes_score"] = {"within_tol": True, "rtol": SCORE_RTOL, "max_abs_err": 0.0,
                          "checked": 0}
    for width in BYTES_WIDTHS:
        xr = torch.from_numpy(scorer_rows(rng, base, width, scorer.rows_per_dispatch(width)))
        xr = xr.cuda()
        got = g(xr)
        want = bytes_gate_plain(xr, g.lut, g.bloom8, g.bloom4)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(int((a - b).abs().max()) for a, b in zip(got, want))
        out["bytes_gate"]["equal"] &= same
        out["bytes_gate"]["max_abs_err"] = max(out["bytes_gate"]["max_abs_err"], err)
        log({"phase": "check", "use": "bytes_gate", "shape": list(xr.shape), "equal": same,
             "max_abs_err": err, "rows_flagged": int((want[0].max(dim=1).values >= 16).sum())})
        check(same, f"bytes gate kernel disagrees with bytes_gate_plain at {width}")
        gcap = scorer.gram_cap(width)
        cap = effective_cap(gcap, width)
        # the full dispatch, and batches of flagged rows as the classifier
        # gathers them (padded with copies of row 0, the over-cap row)
        for n_rows in (None, 8, 16, 64):
            rows = xr if n_rows is None else scorer.take_rows(
                xr, np.arange(min(n_rows - 3, xr.shape[0])), n_rows)
            pfw, pph, pnu = bytes_score_plain(rows, sc.lut, sc.keys, sc.credit, sc.p1, sc.p2,
                                              sc.hash_p, cap, sc.ngram)
            for S in cluster_choices(width):
                fw, ph, nu = sc(rows, gcap, cluster=S)
                torch.cuda.synchronize()
                err = float((fw - pfw).abs().max())
                same = (torch.equal(nu, pnu) and torch.equal(ph, pph)
                        and torch.allclose(fw, pfw, rtol=SCORE_RTOL, atol=0))
                out["bytes_score"]["within_tol"] &= same
                out["bytes_score"]["max_abs_err"] = max(out["bytes_score"]["max_abs_err"], err)
                out["bytes_score"]["checked"] += 1
                log({"phase": "check", "use": "bytes_score", "shape": list(rows.shape),
                     "cluster": S, "policy_cluster": cluster_size(width),
                     "within_tol": same, "rtol": SCORE_RTOL, "full_w_max_abs_err": err,
                     "full_w_max": float(pfw.max()), "n_uniq_over_cap": int((pnu > cap).sum()),
                     "fault_row_n_uniq": int(pnu[0])})
                check(same, f"bytes score kernel disagrees with bytes_score_plain at "
                      f"{list(rows.shape)} in clusters of {S}")
    return out


def score_bound_ms(sc, xs: list, cap: int) -> tuple[float, float, float]:
    """The scorer's bound over dispatches ``xs`` (ms per dispatch at 3.35
    TB/s): the rows, the key column, each credit row that some row of the
    dispatch credits (once, however many rows credit it) and the sums; with
    the credited keys and distinct credit rows per dispatch."""
    R, width = xs[0].shape
    row_bytes = sc.credit.shape[1] * 4
    credited = [credited_keys(t, sc.lut, sc.keys, sc.p1, sc.p2, sc.hash_p, cap, sc.ngram)[1]
                for t in xs]
    hits = float(np.mean([len(pos) for pos in credited]))
    distinct = float(np.mean([torch.unique(pos).numel() for pos in credited]))
    nbytes = R * width + 4 * sc.keys.numel() + distinct * row_bytes + R * (row_bytes + 4)
    return nbytes / HBM_BYTES_PER_S * 1e3, hits, distinct


def shingle_screen_shares(g, x: torch.Tensor) -> dict:
    """The shingle gate's screens on the windows of ``x`` that start on a
    word byte (computed on the host from the plain helpers): the share that
    passes bloom4's screen (2^SCREEN4_BITS bits) and bloom8's at 2^17, 2^18
    and 2^19 bits, beside the share each bloom holds."""
    v = lut_image(x.cpu(), g.lut.cpu())
    valid = v != 0
    wlo, whi = pack_windows(torch.where(valid, v, 32))
    m = mul32(wlo, SHINGLE_MIX)
    h8 = (((m + mul32(whi, SHINGLE_P2)) & M32) >> (32 - SHINGLE_BITS))[valid].numpy()
    h4 = (m >> (32 - SHINGLE_BITS))[valid].numpy()
    b4, b8 = g.bloom4.cpu().numpy() != 0, g.bloom8.cpu().numpy() != 0

    def passes(bloom: np.ndarray, h: np.ndarray, bits: int) -> float:
        screen = bloom.reshape(1 << bits, -1).any(axis=1)
        return float(screen[h >> (SHINGLE_BITS - bits)].mean()) if h.size else 0.0

    return {"windows": int(h4.size), "bloom4_hit_share": float(b4[h4].mean()) if h4.size else 0.0,
            "bloom8_hit_share": float(b8[h8].mean()) if h8.size else 0.0,
            f"screen4_{SCREEN4_BITS}_pass_share": passes(b4, h4, SCREEN4_BITS),
            **{f"screen8_{bits}_pass_share": passes(b8, h8, bits) for bits in (17, 18, 19)}}


def phase_timing_license(base: bytes, base_np: np.ndarray, seed: int, card: str) -> dict:
    """The license kernels at their dispatch shapes behind the device spin,
    beside their plain versions: the gram gate on four distinct [BATCH,
    CHUNK_LEN] batches of seeded text and on one of license text; the
    shingle gate and the scorer on eight distinct full dispatches of
    license and source text at each rung, and the scorer on batches of 8
    and 64 rows gathered from them at 1024, 16384 and 49152. Bounds count
    each input read once and each output written once at 3.35 TB/s: for the
    gate the rows, the LUT, the two key tables and the flags; for
    the shingle gate the rows and the two 512 KiB bitsets; for the scorer
    see ``score_bound_ms``. The shingle gate also with the work one call
    puts on the stream and its screens' pass shares on these license rows
    and on source text."""
    rng = random.Random(seed + 4)
    gate = get_gate_fn(CHUNK_LEN, "cuda")
    scorer = LicenseClassifier(device="cuda")._device_scorer()
    g, sc = scorer._gate, scorer._score
    inputs = gate_inputs(rng, base, base_np, 4)
    nbytes = BATCH * CHUNK_LEN * (1 + 1 / gate.block) + 4 * (
        256 + gate.gate.numel() + gate.anchor.numel())
    out = {}
    for kind, xs in (("seeded", [inputs[f"seeded{i}"] for i in range(4)]),
                     ("license", [inputs["license"]])):
        ms, rounds, host_us = time_cuda(gate, xs, reps=16 // len(xs))
        plain_ms = time_cuda(lambda t: gram_gate_plain(
            t, gate.lut, gate.gate, gate.anchor, gate.p1, gate.p2, gate.hash_p, gate.block,
            gate.ngram), xs[:1], rounds=1)[0]
        res = {"shape": [BATCH, CHUNK_LEN], "input": kind, "ms": ms, "ms_rounds": rounds,
               "host_us_per_call": host_us, "plain_ms": plain_ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               **screen_share(gate, xs[0]), "card": card}
        out["gram_gate" if kind == "seeded" else "gram_gate_license"] = res
        log({"phase": "timing", "use": "gram_gate", **res})
    del inputs
    for width in BYTES_WIDTHS:
        R = scorer.rows_per_dispatch(width)
        xs = [torch.from_numpy(license_rows(rng, base, width, R)).cuda() for _ in range(8)]
        ms, rounds, host_us = time_cuda(g, xs, reps=4)
        per_call = work_per_call(g, xs[:2])
        check(per_call["by_type"] == {"kernel": 1.0},
              f"the shingle gate put {per_call} on the stream per call")
        nbytes = R * width + 2 * (1 << 19) + 1024 + 4 * R * (width // 512 + 2)
        res = {"shape": [R, width], "ms": ms, "ms_rounds": rounds, "host_us_per_call": host_us,
               "launches_per_call": per_call,
               "plain_ms": time_cuda(lambda t: bytes_gate_plain(t, g.lut, g.bloom8, g.bloom4),
                                     xs[:1], rounds=1)[0],
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "screen8_bits": SCREEN8_BITS, "screens_license": shingle_screen_shares(g, xs[0]),
               "card": card}
        if width == 4096:
            src = base_np[np.asarray([rng.randrange(0, len(base_np) - width) for _ in range(R)])
                          [:, None] + np.arange(width)]
            res["screens_source"] = shingle_screen_shares(g, torch.from_numpy(src))
        out[f"bytes_gate_{width}"] = res
        log({"phase": "timing", "use": "bytes_gate", **res})
        gcap = scorer.gram_cap(width)
        cap = effective_cap(gcap, width)
        batches = {R: xs}
        if width in GATHER_WIDTHS:
            for n_rows in (8, 64):  # flagged rows gathered from each dispatch
                batches[n_rows] = [scorer.take_rows(t, np.arange(min(n_rows, R)), n_rows)
                                   for t in xs]
        for n_rows, ts in batches.items():
            S = cluster_size(width)
            ms, rounds, host_us = time_cuda(lambda t: sc(t, gcap), ts, reps=2)
            bound_ms, hits, distinct = score_bound_ms(sc, ts, cap)
            # the other cluster sizes on the same batches: the launch
            # policy's evidence
            by_cluster = {s: time_cuda(lambda t: sc(t, gcap, cluster=s), ts, reps=2)[0]
                          for s in cluster_choices(width) if s != S and width in GATHER_WIDTHS}
            res = {"shape": [n_rows, width], "ms": ms, "ms_rounds": rounds,
                   "host_us_per_call": host_us,
                   "plain_ms": time_cuda(lambda t: bytes_score_plain(
                       t, sc.lut, sc.keys, sc.credit, sc.p1, sc.p2, sc.hash_p, cap, sc.ngram),
                       ts[:1], rounds=1)[0],
                   "credited_keys_per_batch": hits, "credit_rows_per_batch": distinct,
                   "bound_ms": bound_ms, "bound_by": "bytes", "cluster": S,
                   **sc.plan(width, S),
                   "ms_by_cluster": {str(k): v for k, v in sorted({S: ms, **by_cluster}.items())},
                   "card": card}
            out[f"bytes_score_{width}" if n_rows == R else f"bytes_score_{n_rows}x{width}"] = res
            log({"phase": "timing", "use": "bytes_score", **res})
        del xs, batches
    torch.cuda.empty_cache()
    return out


def write_tree(root: Path, e2e_mib: int, seed: int, base: bytes) -> tuple[list, int]:
    """The e2e tree; returns the planted (relpath, rule_id, line) and the
    bytes written. ``root/sub16`` is a ~16 MiB subset with its own plants."""
    rng = random.Random(seed)
    ids = sorted(SAMPLES)
    planted = []
    written = 0

    def put(rel: str, data: bytes) -> None:
        nonlocal written
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        written += len(data)

    def text(n: int) -> bytes:
        off = rng.randrange(0, len(base) - n)
        return base[off : off + n]

    def planted_file(rel: str, n: int, crlf: bool = False) -> None:
        body = text(n)
        cut = body.rfind(b"\n", 0, rng.randrange(1, n)) + 1
        rid = rng.choice(ids)
        head, tail = body[:cut], body[cut:]
        data = head + SAMPLES[rid].encode() + b"\n" + tail
        planted.append((rel, rid, head.count(b"\n") + 1))
        put(rel, data.replace(b"\n", b"\r\n") if crlf else data)

    def tree(prefix: str, big: int, small: int) -> None:
        for i in range(big):
            rel = f"{prefix}src{i % 16}/module_{i}.py"
            if rng.random() < 0.02 or i == 0:
                planted_file(rel, 1 << 20)
            else:
                put(rel, text(1 << 20))
        for i in range(small):
            rel = f"{prefix}pkg{i % 64}/cfg_{i}.conf"
            n = rng.randint(512, 16 << 10)
            if rng.random() < 0.02:
                planted_file(rel, n)
            else:
                put(rel, text(n))
        planted_file(f"{prefix}win/crlf.env", 4096, crlf=True)
        secret = SAMPLES["github-pat"].encode() + b"\n"
        put(f"{prefix}node_modules/dep/index.js", text(2048) + secret)  # skipped dir
        put(f"{prefix}package-lock.json", text(2048) + secret)  # skipped lockfile
        put(f"{prefix}bin/tool.bin", bytes(rng.randrange(256) for _ in range(8192)) + secret)
        put(f"{prefix}bin/blob", b"\x00\x01\x02" + secret)  # binary content

    tree("sub16/", 8, 1000)
    tree("", max(0, e2e_mib - 16), 3000)
    return planted, written


def run_cli(target: Path, out_dir: Path, tag: str, device: str, *extra: str,
            scanners: str = "secret") -> tuple[dict, dict]:
    out, stats = out_dir / f"{tag}.json", out_dir / f"{tag}.stats.json"
    rc = cli.main(["fs", "--scanners", scanners, "--format", "json", "-o", str(out),
                   "--stats-out", str(stats), "--device", device, "-q", *extra, str(target)])
    check(rc == 0, f"fs scan ({tag}) exited {rc}")
    return json.loads(out.read_text()), json.loads(stats.read_text())


def cpu_cli(target: Path, out_dir: Path, tag: str, *extra: str, scanners: str = "secret",
            command: str = "fs") -> subprocess.Popen:
    """:func:`run_cli` with ``--device cpu`` in a child process (``python -m
    trivy_tpu_torch``, four threads), so that a CPU reference runs beside
    the card's scans; :func:`cpu_cli_wait` reads its report."""
    out, stats = out_dir / f"{tag}.json", out_dir / f"{tag}.stats.json"
    return subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch", command, "--scanners", scanners, "--format",
         "json", "-o", str(out), "--stats-out", str(stats), "--device", "cpu", "-q", *extra,
         str(target)],
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "4"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def cpu_cli_wait(proc: subprocess.Popen, out_dir: Path, tag: str) -> tuple[dict, dict]:
    _, err = proc.communicate()
    check(proc.returncode == 0,
          f"fs scan ({tag}) exited {proc.returncode}: {err.decode()[-2000:]}")
    return (json.loads((out_dir / f"{tag}.json").read_text()),
            json.loads((out_dir / f"{tag}.stats.json").read_text()))


def found(report: dict, prefix: str = "") -> set:
    return {
        (prefix + r["Target"], s["RuleID"], s["StartLine"])
        for r in report["Results"] for s in r.get("Secrets", [])
    }


# the feed counters each scan reports: dedup, zero gate, wire
FEED_KEYS = (
    "chunks", "chunks_uploaded", "chunks_dedup_hit", "bytes_dedup_hit", "chunks_gated_zero",
    "bytes_gated", "bytes_uploaded", "bytes_compressed", "bytes_raw_equiv",
    "bytes_raw_fallback", "bytes_gated_binary", "batches_compressed", "batches_raw_fallback",
    "chunks_warm_hit", "files_packed", "bytes_packed",
)


def feed_counters(stats: dict) -> dict:
    out = {k: stats[k] for k in FEED_KEYS}
    raw = stats["bytes_raw_equiv"] + stats["bytes_raw_fallback"]
    if raw:
        out["wire_ratio"] = (stats["bytes_compressed"] + stats["bytes_raw_fallback"]) / raw
    return out


def phase_e2e(root: Path, e2e_mib: int, seed: int, base: bytes) -> tuple[dict, list]:
    """The main path on the e2e tree under ``root``; returns the result and
    the planted secrets."""
    t0 = time.perf_counter()
    planted, written = write_tree(root, e2e_mib, seed, base)
    setup_s = time.perf_counter() - t0
    # the main path: counters to 0 just before, read just after
    LAUNCHES.clear()
    report, stats = run_cli(root, root.parent, "e2e", "cuda")
    launches = dict(LAUNCHES)
    got = found(report)
    missed = [p for p in planted if p not in got]
    leaked = [t for t, *_ in got if "node_modules/" in t or t.endswith("package-lock.json")]
    result = {
        "phase": "e2e", "tree_bytes": written, "setup_s": setup_s,
        "files_walked": stats["files_walked"], "files_scanned": stats["files_scanned"],
        "bytes_scanned": stats["bytes_in"], "seconds": stats["seconds"],
        "MBps": stats["bytes_in"] / stats["seconds"] / 1e6,
        "rows": stats["rows"], "batches": stats["batches"],
        "rows_nfa_skipped": stats["rows_nfa_skipped"],
        "batches_nfa_skipped": stats["batches_nfa_skipped"],
        "rows_prefilter_hit": stats["rows_prefilter_hit"],
        "feed": feed_counters(stats),
        "launches": launches, "planted": len(planted), "missed": missed[:10],
        "findings": len(got),
    }
    log(result)
    check(not missed, f"{len(missed)} planted secrets not reported: {missed[:5]}")
    check(not leaked, f"skipped files reported: {leaked[:5]}")
    check(all(launches.get(k, 0) > 0 for k in ("prefilter", "anchored", "decompress")),
          f"a kernel was not launched on the main path: {launches}")
    # the same tree on the raw feed, to weigh the codec's host work against
    # the link bytes it saves
    raw_report, raw = run_cli(root, root.parent, "e2e-raw", "cuda", "--secret-compress", "off")
    log({"phase": "e2e-raw", "seconds": raw["seconds"],
         "MBps": raw["bytes_in"] / raw["seconds"] / 1e6, "batches": raw["batches"],
         "bytes_uploaded": raw["bytes_uploaded"],
         "equal_to_default_feed": raw_report["Results"] == report["Results"]})
    check(raw_report["Results"] == report["Results"], "e2e: Results differ without compression")
    # the 16 MiB subset: the card's Results equal the port's CPU runs, with
    # the CPU's default feed (dedup on) and with dedup and compression off
    sub = root / "sub16"
    on_card, _ = run_cli(sub, root.parent, "sub16-cuda", "cuda")
    on_cpu, _ = run_cli(sub, root.parent, "sub16-cpu", "cpu")
    plain, _ = run_cli(sub, root.parent, "sub16-cpu-plain", "cpu",
                       "--secret-compress", "off", "--no-secret-dedup")
    same = on_card["Results"] == on_cpu["Results"] == plain["Results"]
    log({"phase": "e2e-subset", "target_bytes": sum(
        f.stat().st_size for f in sub.rglob("*") if f.is_file()),
        "results": len(on_card["Results"]), "equal_to_cpu": same})
    check(same, "16 MiB subset: Results on the card differ from --device cpu")
    return result, planted


# bytes of the subset's files (in name order) that the dedup phase copies
# twice: a few hundred small files, each a duplicate of another, and a CPU
# reference scan that stays short
DEDUP_COPY_BYTES = 2 << 20


def phase_dedup(tmp: Path, tree: Path, planted: list, seed: int, base: bytes) -> dict:
    """The subset's first :data:`DEDUP_COPY_BYTES` twice, eight zero-filled
    1 MiB files and a planted file with its copy, on the card's default
    feed, with counters to 0 just before and read just after; then the CPU
    reference and two runs with the persistent hit store."""
    root = tmp / "dedup"
    copied: set[str] = set()
    total = 0
    for src in sorted(p for p in (tree / "sub16").rglob("*") if p.is_file()):
        if total >= DEDUP_COPY_BYTES:
            break
        rel = src.relative_to(tree / "sub16").as_posix()
        for copy in ("a", "b"):
            (root / copy / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(src, root / copy / rel)
        copied.add(rel)
        total += src.stat().st_size
    rng = random.Random(seed + 1)

    def text(n: int) -> bytes:
        off = rng.randrange(0, len(base) - n)
        body = base[off : off + n]
        return body[: body.rfind(b"\n") + 1]

    head = text(1024)  # printable, so the analyzer's binary sniff passes
    (root / "zero").mkdir()
    for i in range(8):
        (root / "zero" / f"disk{i}.img").write_bytes(head + bytes(1 << 20) + head)
    rid = sorted(SAMPLES)[seed % len(SAMPLES)]
    body = text(1 << 20)
    cut = body.rfind(b"\n", 0, len(body) // 2) + 1
    data = body[:cut] + SAMPLES[rid].encode() + b"\n" + body[cut:]
    line = body[:cut].count(b"\n") + 1
    for rel in ("p/secret.py", "p/copy/secret.py"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    want = {(f"{c}/{rel[len('sub16/'):]}", r, ln) for rel, r, ln in planted
            if rel.startswith("sub16/") and rel[len("sub16/"):] in copied
            for c in ("a", "b")}
    want |= {("p/secret.py", rid, line), ("p/copy/secret.py", rid, line)}

    LAUNCHES.clear()
    report, stats = run_cli(root, tmp, "dedup-cuda", "cuda")
    launches = dict(LAUNCHES)
    ref, _ = run_cli(root, tmp, "dedup-cpu", "cpu", "--no-secret-dedup",
                     "--secret-compress", "off")
    cache = ["--secret-hit-cache", "--cache-dir", str(tmp / "cache")]
    cold, cold_stats = run_cli(root, tmp, "dedup-cold", "cuda", *cache)
    warm, warm_stats = run_cli(root, tmp, "dedup-warm", "cuda", *cache)
    missed = sorted(want - found(report))
    result = {
        "phase": "dedup", "tree_bytes": sum(f.stat().st_size for f in root.rglob("*")
                                            if f.is_file()),
        "seconds": stats["seconds"], "MBps": stats["bytes_in"] / stats["seconds"] / 1e6,
        "batches": stats["batches"], "feed": feed_counters(stats), "launches": launches,
        "planted": len(want), "missed": missed[:10],
        "equal_to_cpu_plain": report["Results"] == ref["Results"],
        "hit_cache": {"cold_batches": cold_stats["batches"],
                      "warm_batches": warm_stats["batches"],
                      "warm_chunks_warm_hit": warm_stats["chunks_warm_hit"],
                      "warm_seconds": warm_stats["seconds"],
                      "equal": cold["Results"] == warm["Results"] == ref["Results"]},
    }
    log(result)
    check(stats["chunks_dedup_hit"] > 0, "dedup: no row was served by dedup")
    check(stats["chunks_gated_zero"] > 0, "dedup: no zero row was gated")
    check(not missed, f"dedup: {len(missed)} planted secrets not reported: {missed[:5]}")
    check(result["equal_to_cpu_plain"], "dedup: Results differ from --device cpu, dedup "
          "and compression off")
    check(warm_stats["batches"] == 0, f"dedup: warm re-scan dispatched "
          f"{warm_stats['batches']} batches")
    check(result["hit_cache"]["equal"], "dedup: hit-cache runs changed the Results")
    return result


# the size classes of the planted license files: below each rung of the
# text-row ladder, and past the widest (the host oracle's)
LICENSE_SIZES = (*BYTES_WIDTHS, 65536)
LICENSE_NAMES = ("LICENSE", "COPYING", "LICENSE.txt", "NOTICE")
HEADERS = {
    ".py": "# Permission is hereby granted, free of charge, to any person obtaining a copy\n"
           "# THE SOFTWARE IS PROVIDED \"AS IS\", WITHOUT WARRANTY OF ANY KIND\n"
           "# The above copyright notice and this permission notice shall be included\n",
    ".go": "// " + FULL_TEXTS["Apache-2.0"][:2500] + "\n",
    ".c": "/* " + FULL_TEXTS["BSD-3-Clause"] + " */\n",
}


def write_license_tree(root: Path, mib: int, seed: int, base: bytes,
                       license_files: int = 2048) -> tuple[dict, int]:
    """The license tree; returns {relpath: license name} of the planted
    license files and the bytes written. ``root/sub`` is a subset with its
    own plants (each text in each form once), headers and source.
    ``license_files`` license files (cycling through every text, form and
    width rung) come before the source that fills the tree to ``mib``."""
    rng = random.Random(seed + 7)
    keys = sorted(FULL_TEXTS)
    planted: dict[str, str] = {}
    written = 0

    def put(rel: str, data: bytes) -> None:
        nonlocal written
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        written += len(data)

    def license_file(folder: str, i: int) -> None:
        key = keys[i % len(keys)]
        top = LICENSE_SIZES[(i // (3 * len(keys))) % len(LICENSE_SIZES)]
        name = f"LICENSE-{key}" if i % 5 == 4 else LICENSE_NAMES[i % len(LICENSE_NAMES)]
        rel = f"{folder}/{name}"
        put(rel, license_text(rng, base, key, (i // len(keys)) % 3, rng.randrange(top // 2, top)))
        planted[rel] = key

    def text(n: int) -> bytes:
        off = rng.randrange(0, len(base) - n)
        return base[off : off + n]

    def header_file(rel: str, ext: str) -> None:
        put(rel + ext, HEADERS[ext].encode() + text(rng.randrange(2048, 8192)))

    for i in range(license_files):
        license_file(f"lic/d{i % 64}/p{i}", i)
    for i in range(3 * len(keys)):
        license_file(f"sub/lic/p{i}", i)
    for i in range(32):
        header_file(f"sub/hdr/mod_{i}", sorted(HEADERS)[i % len(HEADERS)])
    put("sub/src/module.py", text(256 << 10))
    for i in range(512):
        header_file(f"hdr/h{i % 16}/mod_{i}", sorted(HEADERS)[i % len(HEADERS)])
    i = 0
    while written < mib << 20:
        put(f"src{i % 16}/module_{i}.py", text(1 << 20))
        i += 1
    return planted, written


def licenses_found(report: dict) -> dict[str, set]:
    out: dict[str, set] = {}
    for r in report["Results"]:
        for d in r.get("Licenses", []):
            out.setdefault(d["FilePath"], set()).add(d["Name"])
    return out


def phase_license(root: Path, mib: int, seed: int, base: bytes) -> dict:
    """This slice's main path: ``fs --scanners secret,license
    --license-full`` on the card over the license tree, with the launch
    counters set to 0 just before and read just after; then the secret-only
    scan of the same tree and the subset against ``--device cpu``."""
    t0 = time.perf_counter()
    planted, written = write_license_tree(root, mib, seed, base)
    setup_s = time.perf_counter() - t0
    LAUNCHES.clear()
    LAUNCH_SHAPES.clear()
    report, stats = run_cli(root, root.parent, "license", "cuda", "--license-full",
                            scanners="secret,license")
    launches = dict(LAUNCHES)
    by_shape = {name: {f"{b}x{c}": n for (k, b, c), n in sorted(LAUNCH_SHAPES.items())
                       if k == name} for name in ("bytes_gate", "bytes_score")}
    got = licenses_found(report)
    missed = sorted(rel for rel, key in planted.items() if key not in got.get(rel, ()))
    headers = sum(1 for p in got if p.startswith(("hdr/", "sub/hdr/")))
    _, secret_only = run_cli(root, root.parent, "license-secret-only", "cuda")
    unfused, unfused_stats = run_cli(root, root.parent, "license-unfused", "cuda",
                                     "--license-full", "--no-shared-arena",
                                     scanners="secret,license")
    sub = root / "sub"
    on_card, _ = run_cli(sub, root.parent, "license-sub-cuda", "cuda", "--license-full",
                         scanners="secret,license")
    on_cpu, _ = run_cli(sub, root.parent, "license-sub-cpu", "cpu", "--license-full",
                        scanners="secret,license")
    result = {
        "phase": "license", "tree_bytes": written, "setup_s": setup_s,
        "files_walked": stats["files_walked"], "files_scanned": stats["files_scanned"],
        "seconds": stats["seconds"], "MBps": written / stats["seconds"] / 1e6,
        "secret_only_seconds": secret_only["seconds"],
        "secret_only_MBps": written / secret_only["seconds"] / 1e6,
        "unfused_seconds": unfused_stats["seconds"],
        "unfused_MBps": written / unfused_stats["seconds"] / 1e6,
        "unfused_results_equal": unfused["Results"] == report["Results"],
        **gate_counters(stats), "rows": stats["rows"], "launches": launches,
        "launches_by_shape": by_shape,
        "planted": len(planted), "missed": missed[:10], "files_with_licenses": len(got),
        "headers_with_licenses": headers,
        "subset_results_equal_cpu": on_card["Results"] == on_cpu["Results"],
        "subset_files_with_licenses": len(licenses_found(on_card)),
    }
    log(result)
    check(not missed, f"license: {len(missed)} planted licenses not reported: {missed[:5]}")
    check(all(launches.get(k, 0) > 0 for k in (*LICENSE_KERNELS, "prefilter", "decompress")),
          f"license: a kernel was not launched on the main path: {launches}")
    check(headers > 0, "license: no header was classified")
    check(result["subset_results_equal_cpu"], "license subset: Results differ from --device cpu")
    check(result["unfused_results_equal"], "license: Results differ with --no-shared-arena")
    return result


# the feed phase: the transfer streams and windows on the e2e tree's sub16
# subset, a race probe, the controller, an autotune record and the redis
# cache. The grid is the default and four streams with one window, and
# --parallel runs at its default alone, not every setting: no setting of the
# full grid, nor --parallel 1 or 16, stood apart from the phase's own drift,
# and the whole smoke must stay inside its time
FEED_GRID = ((1, 2), (4, 1))  # (streams, in-flight windows)
# the race probe: the smallest arena under the deepest windows, on 64-row
# batches (many short batches in flight at once)
FEED_RACE = ("--secret-arena-slabs", "2", "--secret-inflight", "3", "--secret-streams", "4")
FEED_RACE_BATCH = 64


def feed_run(target: Path, out: Path, tag: str, *extra: str, scanners: str = "secret") -> tuple:
    """One card scan of ``target`` under ``torch.profiler`` with
    ``--metrics-out``: its report and a row of MB/s, the streams' feed_wait
    share (their ``secret.feed_wait`` seconds over streams x scan seconds),
    the card's busy share (kernel time over the scan's wall time), the
    secret stall verdict, the launches and the tuning block."""
    metrics = out / f"{tag}.metrics.json"
    LAUNCHES.clear()
    (report, stats), busy_ms, n_kernels = profiled_kernel_ms(
        lambda: run_cli(target, out, tag, "cuda", "--metrics-out", str(metrics), *extra,
                        scanners=scanners))
    launches = dict(LAUNCHES)
    m = json.loads(metrics.read_text())
    tuning = m.get("tuning") or {}
    ctl = tuning.get("controller") or {}
    streams = (ctl.get("final") or {}).get("feed_streams") or \
        tuning["config"]["feed_streams"] or secret_scanner.FEED_STREAMS
    feed_wait = m["spans"].get("secret.feed_wait", {}).get("total", 0.0)
    row = {
        "tag": tag, "flags": " ".join(extra), "seconds": stats["seconds"],
        "MBps": stats["bytes_in"] / stats["seconds"] / 1e6, "batches": stats["batches"],
        "feed_wait_share": feed_wait / (streams * stats["seconds"]),
        "busy_share": busy_ms / (stats["seconds"] * 1e3), "kernels_profiled": n_kernels,
        "stall": m["stall"].get("secret"), "launches": launches,
        "source": {k: v for k, v in tuning["config"]["source"].items() if v != "default"},
    }
    if ctl:
        row["controller"] = {k: ctl.get(k) for k in ("ticks", "decisions", "initial", "final")}
        row["decision_log"] = ctl.get("decision_log", [])[:20]
    return report, stats, row


def phase_feed(root: Path, e2e_tree: Path, license_tree: Path, card: str) -> dict:
    """The feed's knobs on the card: the ``FEED_GRID`` settings of
    ``--secret-streams`` and ``--secret-inflight`` over the e2e tree's
    16 MiB ``sub16`` subset (``--parallel`` at its default only), each
    run's ``Results`` against the e2e phase's ``--device cpu`` scan of it;
    the race probe; the subset and the license phase's subset with
    ``--tune`` against their
    ``--device cpu`` scans; an autotune record in ``root`` that a ``--tuning-file`` scan
    resolves from; and the redis cache (an in-process fake server): a cold
    and a warm ``--secret-hit-cache`` scan, then one whose every redis GET
    fails, which completes with ``CacheDegraded``."""
    from trivy_tpu_torch.tuning import save_autotune, topology_fingerprint

    t_phase = time.perf_counter()
    cut = e2e_tree / "sub16"
    cut_bytes = sum(f.stat().st_size for f in cut.rglob("*") if f.is_file())
    out = root / "out"
    out.mkdir(parents=True)
    # the e2e phase's CPU scan of the subset, with the same options
    want = json.loads((e2e_tree.parent / "sub16-cpu.json").read_text())["Results"]
    rows = []
    unequal = []

    def sweep(tag: str, *extra: str) -> dict:
        report, _, row = feed_run(cut, out, tag, *extra)
        row["results_equal_cpu"] = report["Results"] == want
        if not row["results_equal_cpu"]:
            unequal.append(tag)
        rows.append(row)
        log({"phase": "feed-run", **row})
        return row

    for streams, inflight in FEED_GRID:
        sweep(f"s{streams}-i{inflight}", "--secret-streams", str(streams),
              "--secret-inflight", str(inflight))
    default = f"s{secret_scanner.FEED_STREAMS}-i{secret_scanner.FEED_INFLIGHT}"
    best = max(rows, key=lambda r: r["MBps"])
    # the race probe: many short batches through the smallest arena
    default_batch = secret_scanner.BATCH
    secret_scanner.BATCH = FEED_RACE_BATCH
    try:
        race = sweep("race", *FEED_RACE)
    finally:
        secret_scanner.BATCH = default_batch
    # an autotune record of the sweep, read back through --tuning-file
    record = root / "AUTOTUNE.json"
    topology = topology_fingerprint("cuda")
    b_streams, b_inflight = (int(x[1:]) for x in best["tag"].split("-")[:2])
    save_autotune(str(record), topology, {"feed_streams": b_streams, "inflight": b_inflight},
                  [{k: r[k] for k in ("tag", "MBps", "feed_wait_share", "busy_share")}
                   for r in rows], meta={"card": card})
    tuned = sweep("autotune", "--tuning-file", str(record))
    # the controller on the subset and on the license phase's subset
    full = []
    for tag, tree, scanners, extra, ref in (
            ("e2e-tune", cut, "secret", (), want),
            ("license-tune", license_tree / "sub", "secret,license", ("--license-full",),
             json.loads((license_tree.parent / "license-sub-cpu.json").read_text())["Results"])):
        # a short cadence: the two scans take seconds, not the e2e tree's half minute
        report, stats, row = feed_run(tree, out, tag, "--tune", "--tuning-interval", "0.1",
                                      *extra, scanners=scanners)
        row["results_equal"] = report["Results"] == ref
        full.append(row)
        log({"phase": "feed-run", **row})
    # the redis cache: the port's RedisCache against the fake RESP server
    fake = runpy.run_path(str(REPO / "tests" / "test_redis_cache.py"))["FakeRedis"]().start()
    try:
        url = f"redis://127.0.0.1:{fake.port}"
        sub = cut
        redis = {}
        for tag, extra in (("cold", ()), ("warm", ()),
                           ("degraded", ("--fault-inject", "cache.redis.get:times=-1"))):
            report, stats = run_cli(sub, out, f"redis-{tag}", "cuda", "--cache-backend", url,
                                    "--secret-hit-cache", *extra)
            redis[tag] = {"seconds": stats["seconds"], "batches": stats["batches"],
                          "chunks_warm_hit": stats["chunks_warm_hit"],
                          "cache_degraded": report["Metadata"].get("CacheDegraded", False),
                          "results": report["Results"]}
        keys = sum(1 for k in fake.data if k.startswith("fanal::blob::"))
    finally:
        fake.stop()
        faults.clear()
    redis_equal = all(r.pop("results") == want for r in redis.values())
    result = {
        "phase": "feed", "cut_bytes": cut_bytes, "default": default, "best": best["tag"],
        "sweep": [{k: r[k] for k in ("tag", "MBps", "feed_wait_share", "busy_share",
                                     "batches", "results_equal_cpu")} for r in rows],
        "race": {k: race[k] for k in ("MBps", "batches", "launches", "results_equal_cpu")},
        "autotune": {"topology": topology, "source": tuned["source"],
                     "results_equal_cpu": tuned["results_equal_cpu"]},
        "tune": full, "redis": redis, "redis_keys": keys,
        "redis_results_equal_cpu": redis_equal,
        "seconds": time.perf_counter() - t_phase, "card": card,
    }
    log(result)
    check(not unequal, f"feed: Results differ from --device cpu at {unequal}")
    check(all(r["launches"].get("prefilter", 0) > 0 for r in rows),
          "feed: a run launched no prefilter")
    check(race["batches"] > 2 * len(FEED_GRID), f"feed: race probe made {race['batches']} "
          "batches")
    check(tuned["source"].get("feed_streams") == tuned["source"].get("inflight") == "autotune",
          f"feed: the --tuning-file scan resolved {tuned['source']}")
    check(all(r["results_equal"] for r in full), "feed: --tune changed the Results")
    check(all(r["controller"]["ticks"] > 0 for r in full), "feed: the controller never ticked")
    check(redis["warm"]["batches"] == 0 and redis["warm"]["chunks_warm_hit"] > 0 and keys > 0,
          f"feed: the warm redis scan was not served by redis: {redis['warm']}")
    check(redis["degraded"]["cache_degraded"] and not redis["warm"]["cache_degraded"],
          "feed: a dead redis GET did not mark the report CacheDegraded")
    check(redis_equal, "feed: Results over redis differ from --device cpu")
    result["cut_results"] = want  # phase mesh scans the same subset
    return result


def gate_counters(stats: dict) -> dict:
    """The fused gate's selection from a scan's ``--stats-out``: rows gated
    and flagged (in all and by each lane), files covered, flagged and
    patched."""
    keys = ("license_rows_gated", "license_rows_flagged", "license_rows_gram",
            "license_rows_anchor", "license_rows_nonascii", "files_covered", "files_flagged",
            "files_patched")
    return {k: stats[k] for k in keys}


# the repository's own code, scanned by phase license-repo; ``tests`` is
# copied as ``suite`` because the secret rules' allow paths keep ``tests/``
# off the feed (its files would be classified without the gate)
REPO_TREES = {"trivy_tpu": "trivy_tpu", "trivy_tpu_torch": "trivy_tpu_torch", "tests": "suite"}


def phase_license_repo(root: Path) -> dict:
    """The fused gate on real code: the checkout's own packages and tests,
    ``fs --scanners secret,license --license-full`` on the card, fused and
    with ``--no-shared-arena`` (every wanted file classified, no gate), and
    secret-only, twice each in alternating order; the gate's selection and
    each scan's MB/s. Both license scans must give the same Results."""
    for src, dst in REPO_TREES.items():
        shutil.copytree(REPO / src, root / dst, ignore=shutil.ignore_patterns("__pycache__"))
    written = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    runs = {"fused": ("--license-full",), "unfused": ("--license-full", "--no-shared-arena"),
            "secret_only": ()}
    mbps: dict[str, list] = {k: [] for k in runs}
    reports, fused_stats = {}, None
    for i in range(2):
        for mode, extra in runs.items():
            report, stats = run_cli(root, root.parent, f"repo-{mode}-{i}", "cuda", *extra,
                                    scanners="secret" if mode == "secret_only" else
                                    "secret,license")
            mbps[mode].append(written / stats["seconds"] / 1e6)
            reports[mode] = report
            if mode == "fused":
                fused_stats = stats
    result = {"phase": "license-repo", "tree_bytes": written,
              "files_walked": fused_stats["files_walked"], **gate_counters(fused_stats),
              **{f"{mode}_MBps": v for mode, v in mbps.items()},
              "results_equal": reports["fused"]["Results"] == reports["unfused"]["Results"],
              "files_with_licenses": len(licenses_found(reports["fused"]))}
    log(result)
    check(result["results_equal"], "license-repo: fused Results differ from --no-shared-arena")
    return result

VERSCMP_WIDTHS = (1, 8, 24, 40, 72)


def version_rows(rng, n: int, L: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` pairs of [L] int32 rows of small values (so that prefixes
    repeat): a sixth equal, a sixth differing only in the last column (in
    both directions), the rest differing anywhere."""
    a = rng.integers(0, 4, (n, L), dtype=np.int32)
    b = a.copy()
    k = n // 6
    b[2 * k :] = rng.integers(0, 4, (n - 2 * k, L), dtype=np.int32)
    b[k : 2 * k, -1] = (a[k : 2 * k, -1] + rng.integers(1, 4, k)) % 4
    return a, b


def phase_check_verscmp(rng) -> dict:
    """The version-constraint kernel against its plain version on the card,
    at each of ``VERSCMP_WIDTHS``: the gather entry (every operator, indices
    into both matrices) and the null-index entries, ``lexcmp`` (signs) and
    ``check_ops``."""
    equal, err, cases = True, 0, []
    for L in VERSCMP_WIDTHS:
        a_np, b_np = version_rows(rng, 3000, L)
        a, b = torch.from_numpy(a_np).cuda(), torch.from_numpy(b_np).cuda()
        R = 20000
        a_idx = torch.from_numpy(rng.integers(0, len(a_np), R, dtype=np.int32)).cuda()
        b_idx = torch.where(torch.from_numpy(rng.random(R) < 0.5).cuda(), a_idx,
                            torch.from_numpy(rng.integers(0, len(b_np), R, dtype=np.int32))
                            .cuda())
        ops = torch.arange(R, dtype=torch.int32, device="cuda") % 6
        pairs = [
            ("gather", check_ops_gather(a, b, a_idx, b_idx, ops),
             check_ops_gather_plain(a, b, a_idx, b_idx, ops)),
            ("lexcmp", lexcmp(a, b), lexcmp_plain(a, b)),
            ("check_ops", check_ops(a, b, ops[: len(a_np)]),
             check_ops_plain(a, b, ops[: len(a_np)])),
        ]
        torch.cuda.synchronize()
        for entry, got, want in pairs:
            same = torch.equal(got, want)
            e = int((got.int() - want.int()).abs().max())
            equal &= same
            err = max(err, e)
            cases.append({"L": L, "entry": entry, "rows": int(got.shape[0]), "equal": same,
                          "max_abs_err": e, "nonzero": int((want != 0).sum())})
    log({"phase": "check", "use": "verscmp", "equal": equal, "max_abs_err": err,
         "cases": cases})
    check(equal, "verscmp kernel disagrees with its plain version")
    return {"equal": equal, "max_abs_err": err}


# bench.py::bench_cve's DB: real trivy-db source buckets, advisories each
CVE_BUCKETS = (
    ("npm::GitHub Security Advisory Npm", 30_000),
    ("npm::Node.js Ecosystem Security Working Group", 10_000),
    ("pip::GitHub Security Advisory Pip", 20_000),
    ("pip::OSV/PyPA Advisory Database", 8_000),
    ("go::GitHub Security Advisory Go", 15_000),
    ("go::GitLab Advisory Database Community", 7_000),
    ("composer::GitHub Security Advisory Composer", 6_000),
    ("composer::php-security-advisories", 2_000),
    ("rubygems::ruby-advisory-db", 4_000),
    ("cargo::GitHub Security Advisory Rust", 4_000),
)
# the SBOM's applications: (purl type, bucket prefix, components, distinct names)
CVE_APPS = (("npm", "npm", 50_000, 15_000), ("golang", "go", 30_000, 7_500),
            ("cargo", "cargo", 20_000, 2_000), ("pypi", "pip", 2_000, 2_000))
CVE_PLANTS = 200
DEB_PACKAGES = 500


def plants() -> list[tuple]:
    """(purl type, bucket, name, vulnerability ID, vulnerable version, patched
    version) of each planted package: its one advisory is ``>=lo, <hi``,
    patched at ``hi``; every third vulnerable version is a prerelease of
    ``hi``."""
    out = []
    for k in range(CVE_PLANTS):
        ptype, prefix = (("npm", "npm"), ("golang", "go"), ("cargo", "cargo"))[k % 3]
        hi = f"{2 + k % 5}.{k % 7}.0"
        vuln = f"{hi}-rc.{k % 4}" if k % 3 == 0 else f"{1 + k % 5}.{k % 7}.{3 + k % 4}"
        out.append((ptype, f"{prefix}::GitHub Security Advisory Plants",
                    f"plant-{prefix}-{k:03d}", f"CVE-2099-{k:05d}", vuln, hi))
    return out


def write_cve_db(root: Path) -> int:
    """The flattened advisory DB (``advisories.json``, ``vulnerability.json``
    with details for every fourth ID, ``metadata.json``); returns the count
    of advisories."""
    suffixes = ["", "", "", "-beta.1", "-rc2", ""]
    buckets: dict = {}
    n_adv = 0
    for bname, count in CVE_BUCKETS:
        eco = bname.split("::", 1)[0]
        rows: dict = {}
        for i in range(count):
            lo = f"{i % 9}.{i % 10}.0{suffixes[i % len(suffixes)]}"
            hi = f"{i % 9 + 1}.{i % 10}.0"
            rows.setdefault(f"{eco}-pkg-{i % (count // 2):05d}", []).append(
                {"VulnerabilityID": f"CVE-2024-{n_adv:06d}",
                 "VulnerableVersions": [f">={lo}, <{hi}"], "PatchedVersions": [hi]})
            n_adv += 1
        buckets[bname] = rows
    for _ptype, bucket, name, vid, _vuln, hi in plants():
        buckets.setdefault(bucket, {})[name] = [
            {"VulnerabilityID": vid, "VulnerableVersions": [f">=1.0.0, <{hi}"],
             "PatchedVersions": [hi], "Severity": "CRITICAL"}]
        n_adv += 1
    deb = buckets.setdefault("debian 12", {})
    for k in range(0, DEB_PACKAGES, 2):
        deb[f"deb-lib-{k:03d}"] = [{"VulnerabilityID": f"CVE-2023-{k:05d}",
                                    "FixedVersion": f"1.{k % 7}.{k % 13}-2"}]
        if k % 10 == 0:
            deb[f"deb-lib-{k:03d}"].append({"VulnerabilityID": f"CVE-2022-{k:05d}",
                                            "Status": "affected"})
        n_adv += len(deb[f"deb-lib-{k:03d}"])
    details = {f"CVE-2024-{i:06d}": {
        "Title": f"synthetic advisory {i}", "Description": "seeded", "CweIDs": ["CWE-400"],
        "References": [f"https://example.com/{i}"],
        **({"Severity": "HIGH"} if i % 8 else {"VendorSeverity": {"ghsa": 2, "nvd": 3}})}
        for i in range(0, n_adv, 4)}
    root.mkdir(parents=True)
    (root / "metadata.json").write_text(json.dumps({"Version": 2}))
    (root / "advisories.json").write_text(json.dumps(buckets))
    (root / "vulnerability.json").write_text(json.dumps(details))
    return n_adv


def write_cve_sbom(path: Path, seed: int) -> int:
    """The CycloneDX SBOM; returns its component count."""
    rng = np.random.default_rng(seed)
    comps = []
    for ptype, prefix, n, names in CVE_APPS:
        ver = rng.integers(0, 10, (n, 3))
        ver[:, 0] += ver[:, 0] == 0  # majors 1-9, as bench_cve's
        for i in range(n):
            v = f"{ver[i, 0]}.{ver[i, 1]}.{ver[i, 2]}"
            comps.append({"type": "library", "name": f"{prefix}-pkg-{i % names:05d}",
                          "version": v, "purl": f"pkg:{ptype}/{prefix}-pkg-{i % names:05d}@{v}"})
    for ptype, _bucket, name, _vid, vuln, hi in plants():
        for v in (vuln, hi):
            comps.append({"type": "library", "name": name, "version": v,
                          "purl": f"pkg:{ptype}/{name}@{v}"})
    for k in range(DEB_PACKAGES):
        v = f"1.{(k * 5) % 7}.{k % 13}-{k % 4}"
        comps.append({"type": "library", "name": f"deb-lib-{k:03d}", "version": v,
                      "purl": f"pkg:deb/debian/deb-lib-{k:03d}@{v}?arch=amd64&distro=debian-12"})
    comps.append({"type": "operating-system", "name": "debian", "version": "12"})
    path.write_text(json.dumps({"bomFormat": "CycloneDX", "specVersion": "1.5",
                                "components": comps}))
    return len(comps)


@contextmanager
def captured_dispatches():
    """Every constraint dispatch made in the block
    (``verscmp.check_ops_gather_bucketed``), in order: copies of the first
    one's arrays (inst, the resident bound matrix, a_idx, b_idx, ops), and
    None for each later one, whose ``cve.dispatch.seconds`` then counts no
    copy; the dispatches themselves run as before."""
    captured = []
    original = verscmp.check_ops_gather_bucketed

    def capture(inst, bounds_dev, a_idx, b_idx, ops, stage=None):
        captured.append(None if captured else (
            inst.copy(), bounds_dev, a_idx.copy(), b_idx.copy(), ops.copy()))
        return original(inst, bounds_dev, a_idx, b_idx, ops, stage=stage)

    verscmp.check_ops_gather_bucketed = capture
    try:
        yield captured
    finally:
        verscmp.check_ops_gather_bucketed = original


DISTINCT_ADVISORIES = 106_000  # bench.py::bench_cve's advisories, each with its own range


def distinct_bounds(seed: int, L: int) -> np.ndarray:
    """``[2 * DISTINCT_ADVISORIES, L]`` int32 bound rows of a trivy-db in
    which every advisory has its own range ``>=lo, <hi``: seeded semver
    strings (every fifth lower bound a prerelease) encoded by the port's
    ``version/encode.py``, so rows share prefixes as real versions do."""
    from trivy_tpu_torch.version.encode import encode, pad_value

    rng = np.random.default_rng(seed)
    n = DISTINCT_ADVISORIES
    major, pre = rng.integers(0, 10, n), rng.integers(0, 10, n)
    minor, patch = rng.integers(0, 99, n), rng.integers(0, 100, n)
    out = np.full((2 * n, L), pad_value("semver"), dtype=np.int32)
    for k in range(n):
        lo = f"{major[k]}.{minor[k]}.{patch[k]}" + (f"-rc{pre[k]}" if k % 5 == 0 else "")
        for j, v in enumerate((lo, f"{major[k]}.{minor[k] + 1}.0")):
            enc = encode("semver", v)
            out[2 * k + j, : len(enc)] = enc
    return out


def distinct_index(R: int, seed: int) -> np.ndarray:
    """``b_idx`` of R rows against :func:`distinct_bounds`: in the join's
    runs of two (an advisory's lower, then its upper bound), advisories in
    a seeded order, every bound row reached once R >= 2 * DISTINCT_ADVISORIES."""
    adv = np.random.default_rng(seed).permutation(DISTINCT_ADVISORIES)
    adv = adv[np.arange((R + 1) // 2) % DISTINCT_ADVISORIES]
    return (2 * adv[:, None] + np.arange(2)).ravel()[:R].astype(np.int32)


def verscmp_bound_ms(R: int, L: int, a_idx: np.ndarray, b_idx: np.ndarray) -> float:
    """The least time of one dispatch: each index, op and verdict once, each
    distinct inst and bound row gathered once, at 3.35 TB/s."""
    nbytes = R * (3 * 4 + 1) + 4 * L * (len(np.unique(a_idx)) + len(np.unique(b_idx)))
    return nbytes / HBM_BYTES_PER_S * 1e3


def dispatch_split(inst_np, bounds_dev, a_np, b_np, ops_np, want: np.ndarray,
                   rounds: int = 10) -> dict:
    """The constraint dispatch on the card, in its parts, on one dispatch's
    arrays. Each route first builds the arrays as its detector did, by
    gathers through an index of the rows (here every row in order): the
    path's route (``library._resident_verdicts``) into a ``DispatchStage``'s
    pinned views, then one host-to-card copy, the kernel, one copy back and
    a synchronise; the route it replaced into new arrays, then four
    pageable uploads, the kernel and ``.cpu()``. In turns (old, new, new,
    old) for ``rounds`` rounds after one to warm up: the median ms of each
    part (host clock for the staging and the totals, CUDA events for the
    rest), ``dispatch_ms`` (all but the staging: what ``cve.dispatch.seconds``
    spans), and the work one new dispatch puts on the stream (a CUDA graph's
    nodes); ``equal`` when every run gave the verdicts ``want``. The old
    route is a yardstick only."""
    dev = bounds_dev.device
    R = len(ops_np)
    rows = np.arange(R, dtype=np.int64)
    stage = verscmp.DispatchStage(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def new() -> tuple[dict, np.ndarray]:
        t0 = time.perf_counter()
        inst_v, *views = stage.views(R, *inst_np.shape)
        inst_v[:] = inst_np
        for src, dst in zip((a_np, b_np, ops_np), views):
            np.take(src, rows, out=dst, mode="clip")
        t1 = time.perf_counter()
        ev[0].record()
        inst_d, a_d, b_d, ops_d = stage.upload()
        ev[1].record()
        out = check_ops_gather(inst_d, bounds_dev, a_d, b_d, ops_d)
        ev[2].record()
        host = stage.copy_back(out)
        ev[3].record()
        torch.cuda.current_stream(dev).synchronize()
        verdicts = host.numpy().copy()
        t2 = time.perf_counter()
        return {"staging_ms": (t1 - t0) * 1e3, "h2d_ms": ev[0].elapsed_time(ev[1]),
                "kernel_ms": ev[1].elapsed_time(ev[2]), "d2h_ms": ev[2].elapsed_time(ev[3]),
                "dispatch_ms": (t2 - t1) * 1e3, "total_ms": (t2 - t0) * 1e3}, verdicts

    def old() -> tuple[dict, np.ndarray]:
        t0 = time.perf_counter()
        arrays = (inst_np.copy(), *(x[rows] for x in (a_np, b_np, ops_np)))
        t1 = time.perf_counter()
        ev[0].record()
        inst_d, a_d, b_d, ops_d = (torch.from_numpy(x).to(dev) for x in arrays)
        ev[1].record()
        out = check_ops_gather(inst_d, bounds_dev, a_d, b_d, ops_d)
        ev[2].record()
        verdicts = out.cpu().numpy()
        ev[3].record()
        torch.cuda.current_stream(dev).synchronize()
        t2 = time.perf_counter()
        return {"staging_ms": (t1 - t0) * 1e3, "h2d_ms": ev[0].elapsed_time(ev[1]),
                "kernel_ms": ev[1].elapsed_time(ev[2]), "d2h_ms": ev[2].elapsed_time(ev[3]),
                "dispatch_ms": (t2 - t1) * 1e3, "total_ms": (t2 - t0) * 1e3}, verdicts

    runs = {"new": [], "old": []}
    same = True
    for k in range(rounds + 1):  # round 0 warms both routes up
        for name, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
            parts, verdicts = fn()
            if k:
                runs[name].append(parts)
            same &= bool(np.array_equal(verdicts, want))
    out = {name: {key: float(np.median([r[key] for r in rs])) for key in rs[0]}
           for name, rs in runs.items()}

    def enqueue(_):
        inst_d, a_d, b_d, ops_d = stage.upload()
        stage.copy_back(check_ops_gather(inst_d, bounds_dev, a_d, b_d, ops_d))

    out["new"]["work_per_call"] = work_per_call(enqueue, [None])
    out["equal"] = same
    return out


def phase_cve(root: Path, seed: int, card: str) -> dict:
    """``cli.scan_sbom`` over the cve SBOM: twice on the card with one loaded
    DB (launch counters to 0 just before each scan, read just after), once
    with ``device="cpu"``; then the kernel against its plain version on the
    first scan's captured dispatch and, with the same inst rows, indices and
    ops, against a DB of distinct bounds; its times on both, warm and with a
    cold L2; and the dispatch split beside the route it replaced."""
    t0 = time.perf_counter()
    n_adv = write_cve_db(root / "db")
    bom = root / "bom.json"
    n_comp = write_cve_sbom(bom, seed)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = VulnDB.load(str(root / "db"))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rj = library._resident_join(db)
    join_build_s = time.perf_counter() - t0
    scans = []
    with captured_dispatches() as captured:
        for device in ("cuda", "cuda", "cpu"):
            LAUNCHES.clear()
            report, stats = cli.scan_sbom(str(bom), db=db, device=device)
            launches = dict(LAUNCHES)
            scans.append((device, report.to_dict(), stats, launches))
    results = [r["Results"] for _d, r, _s, _l in scans]
    found = {(v["PkgName"], v["VulnerabilityID"], v["InstalledVersion"])
             for r in results[0] for v in r.get("Vulnerabilities", [])}
    missed = [p for p in plants() if (p[2], p[3], p[4]) not in found]
    patched = [p for p in plants() if any(k[0] == p[2] and k[2] == p[5] for k in found)]
    per_scan = [{
        "device": d, "seconds": st["seconds"], "components_per_s": n_comp / st["seconds"],
        "decode_s": st["decode.seconds"], "detect_s": st["detect.seconds"],
        "join_s": st["cve.join.seconds"], "dispatch_s": st["cve.dispatch.seconds"],
        "candidate_pairs": st["cve.candidate_pairs"], "rows": st["cve.resident_rows"],
        "dispatches": st["cve.dispatch_count"],
        "rows_per_dispatch": st["cve.resident_rows"] / max(1, st["cve.dispatch_count"]),
        "bounds_bytes_uploaded": st["cve.bounds_bytes_uploaded"], "launches": lc,
    } for d, _r, st, lc in scans]
    result = {
        "phase": "cve", "advisories": n_adv, "components": n_comp, "setup_s": setup_s,
        "db_load_s": load_s, "join_build_s": join_build_s, "scans": per_scan,
        "resident_bound_bytes": int(rj.bounds.nbytes), "bound_matrix": list(rj.bounds.shape),
        "results": len(results[0]), "findings": sum(len(r.get("Vulnerabilities", []))
                                                    for r in results[0]),
        "results_equal": results[0] == results[1] == results[2],
        "planted": len(plants()), "missed": missed[:5], "patched_reported": patched[:5],
        "card": card,
    }
    log(result)
    check(result["results_equal"], "cve: Results differ between the card scans and the CPU")
    check(not missed, f"cve: {len(missed)} planted vulnerable components not reported")
    check(not patched, f"cve: {len(patched)} components at their patched version reported")
    check([lc.get("verscmp", 0) for _d, _r, _s, lc in scans] == [1, 1, 0],
          f"cve: verscmp launches per scan {[lc for *_, lc in scans]}")
    check(per_scan[1]["bounds_bytes_uploaded"] == 0, "cve: the second scan uploaded bounds")
    check(len(captured) == 3, f"cve: {len(captured)} dispatches captured, want 3")
    # the kernel against its plain version on the first scan's dispatch and
    # on the same rows against a DB of distinct bounds; its times there
    inst_np, bounds_dev, a_np, b_np, ops_np = captured[0]
    inst = torch.from_numpy(inst_np).cuda()
    a_idx, b_idx, ops = (torch.from_numpy(x).cuda() for x in (a_np, b_np, ops_np))
    R, L = len(ops_np), inst_np.shape[1]
    got = check_ops_gather(inst, bounds_dev, a_idx, b_idx, ops)
    want = check_ops_gather_plain(inst, bounds_dev, a_idx, b_idx, ops)
    t0 = time.perf_counter()
    bd_np = distinct_bounds(seed, L)
    bd_idx_np = distinct_index(R, seed)
    distinct_setup_s = time.perf_counter() - t0
    bounds_d, bd_idx = torch.from_numpy(bd_np).cuda(), torch.from_numpy(bd_idx_np).cuda()
    got_d = check_ops_gather(inst, bounds_d, a_idx, bd_idx, ops)
    want_d = check_ops_gather_plain(inst, bounds_d, a_idx, bd_idx, ops)
    torch.cuda.synchronize()
    equal, equal_d = torch.equal(got, want), torch.equal(got_d, want_d)
    log({"phase": "check", "use": "verscmp-distinct", "equal": equal_d, "shape": [R, L],
         "bound_rows": int(bd_np.shape[0]), "distinct_bound_rows": int(len(np.unique(bd_idx_np))),
         "vulnerable_rows": int(want_d.sum()), "setup_s": distinct_setup_s})
    check(equal, "verscmp kernel disagrees with its plain version on the cve dispatch")
    check(equal_d, "verscmp kernel disagrees with its plain version on distinct bounds")
    args, args_d = (inst, bounds_dev, a_idx, b_idx, ops), (inst, bounds_d, a_idx, bd_idx, ops)
    ms, rounds, host_us = time_cuda(lambda x: check_ops_gather(*x), [args], reps=20)
    ms_d, rounds_d, _ = time_cuda(lambda x: check_ops_gather(*x), [args_d], reps=20)
    ms_cold, cold = time_cold(lambda x: check_ops_gather(*x), [args])
    ms_d_cold, cold_d = time_cold(lambda x: check_ops_gather(*x), [args_d])
    plain_ms = time_cuda(lambda x: check_ops_gather_plain(*x), [args], reps=2)[0]
    plain_ms_d = time_cuda(lambda x: check_ops_gather_plain(*x), [args_d], reps=2)[0]
    timing = {"shape": [R, L], "inst_rows": int(inst_np.shape[0]),
              "bound_rows": int(bounds_dev.shape[0]), "distinct_bound_rows":
              int(len(np.unique(b_np))), "plan": verscmp_cuda.plan(inst, bounds_dev, R),
              "ms": ms, "ms_rounds": rounds, "host_us_per_call": host_us,
              "ms_cold": ms_cold, "ms_cold_spread": [min(cold), max(cold)], "cold_launches":
              len(cold), "plain_ms": plain_ms, "bound_ms": verscmp_bound_ms(R, L, a_np, b_np),
              "bound_by": "bytes", "equal": equal, "vulnerable_rows": int(want.sum()),
              "distinct": {"bound_rows": int(bd_np.shape[0]), "ms": ms_d, "ms_rounds": rounds_d,
                           "ms_cold": ms_d_cold, "ms_cold_spread": [min(cold_d), max(cold_d)],
                           "plain_ms": plain_ms_d,
                           "bound_ms": verscmp_bound_ms(R, L, a_np, bd_idx_np),
                           "equal": equal_d, "vulnerable_rows": int(want_d.sum())},
              "card": card}
    log({"phase": "timing", "use": "verscmp", **timing})
    split = dispatch_split(inst_np, bounds_dev, a_np, b_np, ops_np, want.cpu().numpy())
    log({"phase": "timing", "use": "verscmp-dispatch", "shape": [R, L], **split,
         "scan_dispatch_s": [sc["dispatch_s"] for sc in per_scan[:2]],
         "scan_dispatch_note": "the first scan's span holds the capture's copies", "card": card})
    check(split["equal"], "a dispatch route disagrees with the plain version")
    check(split["new"]["work_per_call"]["by_type"] == {"memcpy": 2, "kernel": 1},
          f"the dispatch is not one copy each way and one kernel: {split['new']['work_per_call']}")
    timing["equal"] = equal and equal_d and split["equal"]
    timing["dispatch"] = split
    result["timing"] = timing
    return result


# the fs-vuln tree: (purl type as in CVE_APPS, lockfile, files)
FS_LOCKFILES = {"npm": ("package-lock.json", 25), "golang": ("go.mod", 30),
                "cargo": ("Cargo.lock", 10)}
FS_NODE_MODULES = 2_000
FS_LICENSES = ("MIT", "Apache-2.0", "ISC", "BSD-3-Clause", "GPL-3.0-only")


def write_fs_tree(root: Path, seed: int, base: bytes) -> tuple[int, list]:
    """A seeded monorepo holding the cve SBOM's components as lockfiles:
    npm in 25 ``package-lock.json`` v3 files, golang in 30 ``go.mod``
    files, cargo in 10 ``Cargo.lock`` files, pypi in a ``poetry.lock`` and
    a ``requirements.txt``, each plant at its vulnerable version in one file
    and at its patched version in the next; a debian 12 root with the 500
    ``deb-lib-*`` packages in ``var/lib/dpkg/status``; 2,000
    ``node_modules/<name>/package.json`` with licenses; 4 MiB of the seeded
    text with planted secrets. Returns the lockfile components and the
    planted (relpath, rule_id, line)."""
    rng = np.random.default_rng(seed)
    comps: dict[str, list] = {}
    for ptype, prefix, n, names in CVE_APPS:
        ver = rng.integers(0, 10, (n, 3))
        ver[:, 0] += ver[:, 0] == 0
        comps[ptype] = [(f"{prefix}-pkg-{i % names:05d}", f"{ver[i, 0]}.{ver[i, 1]}.{ver[i, 2]}")
                        for i in range(n)]
    n_comp = sum(len(c) for c in comps.values())
    files: dict[str, list[list]] = {}
    for ptype, (_name, n_files) in FS_LOCKFILES.items():
        per = len(comps[ptype]) // n_files
        files[ptype] = [comps[ptype][i * per:(i + 1) * per] for i in range(n_files)]
    for k, (ptype, _bucket, name, _vid, vuln, hi) in enumerate(plants()):
        n_files = len(files[ptype])
        files[ptype][k % n_files].append((name, vuln))
        files[ptype][(k + 1) % n_files].append((name, hi))
        n_comp += 2

    def put(rel: str, data: bytes) -> None:
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)

    for j, pkgs in enumerate(files["npm"]):
        lock = {"name": f"web{j}", "lockfileVersion": 3, "packages": {
            "": {"name": f"web{j}", "dependencies": {n: "*" for n, _v in pkgs}},
            **{f"node_modules/{n}": {"version": v} for n, v in pkgs}}}
        put(f"services/web{j:02d}/package-lock.json", json.dumps(lock).encode())
    for j, pkgs in enumerate(files["golang"]):
        body = "\n".join(f"\t{n} v{v}" for n, v in pkgs)
        put(f"services/go{j:02d}/go.mod",
            f"module example.com/go{j}\n\ngo 1.22\n\nrequire (\n{body}\n)\n".encode())
    for j, pkgs in enumerate(files["cargo"]):
        put(f"crates/c{j:02d}/Cargo.lock", "".join(
            f'[[package]]\nname = "{n}"\nversion = "{v}"\n\n' for n, v in pkgs).encode())
    pypi = comps["pypi"]
    half = len(pypi) // 2
    put("py/poetry.lock", "".join(f'[[package]]\nname = "{n}"\nversion = "{v}"\n'
                                  f'category = "main"\n\n' for n, v in pypi[:half]).encode())
    put("py/requirements.txt", "".join(f"{n}=={v}\n" for n, v in pypi[half:]).encode())
    put("etc/os-release", b'PRETTY_NAME="Debian GNU/Linux 12"\nID=debian\nVERSION_ID="12"\n')
    put("var/lib/dpkg/status", "".join(
        f"Package: deb-lib-{k:03d}\nStatus: install ok installed\nArchitecture: amd64\n"
        f"Version: 1.{(k * 5) % 7}.{k % 13}-{k % 4}\n\n" for k in range(DEB_PACKAGES)).encode())
    for k in range(FS_NODE_MODULES):
        put(f"web/node_modules/nm-pkg-{k:04d}/package.json", json.dumps({
            "name": f"nm-pkg-{k:04d}", "version": f"1.{k % 10}.0",
            "license": FS_LICENSES[k % len(FS_LICENSES)]}).encode())
    text_rng = random.Random(seed)
    planted = []
    for i in range(4):
        off = text_rng.randrange(0, len(base) - (1 << 20))
        body = base[off:off + (1 << 20)]
        cut = body.rfind(b"\n", 0, text_rng.randrange(1, len(body))) + 1
        rid = sorted(SAMPLES)[(seed + 7 * i) % len(SAMPLES)]
        rel = f"src/module_{i}.py"
        put(rel, body[:cut] + SAMPLES[rid].encode() + b"\n" + body[cut:])
        planted.append((rel, rid, body[:cut].count(b"\n") + 1))
    return n_comp, planted


def phase_fs_vuln(root: Path, db_dir: Path, seed: int, base: bytes, card: str) -> dict:
    """``cli.scan_fs`` over the monorepo tree with ``--scanners vuln``:
    twice on the card with one loaded DB (launch counters to 0 just before
    each scan, read just after), once with ``device="cpu"``; then
    ``vuln,secret,license`` once on the card and once on the CPU; then the
    kernel against its plain version on the first scan's captured
    dispatch."""
    t0 = time.perf_counter()
    n_comp, planted = write_fs_tree(root / "tree", seed, base)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = VulnDB.load(str(db_dir))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    library._resident_join(db)
    join_build_s = time.perf_counter() - t0
    scans = []
    with captured_dispatches() as captured:
        for scanners, device in ((("vuln",), "cuda"), (("vuln",), "cuda"), (("vuln",), "cpu"),
                                 (("vuln", "secret", "license"), "cuda"),
                                 (("vuln", "secret", "license"), "cpu")):
            LAUNCHES.clear()
            report, stats = cli.scan_fs(str(root / "tree"), scanners=scanners, db=db,
                                        device=device)
            launches = dict(LAUNCHES)
            scans.append((",".join(scanners), device, report.to_dict(), stats, launches))
    vuln_reports = [r for _s, _d, r, _st, _l in scans[:3]]
    full_reports = [r for _s, _d, r, _st, _l in scans[3:]]
    found_v = {(v["PkgName"], v["VulnerabilityID"], v["InstalledVersion"])
               for r in vuln_reports[0]["Results"] for v in r.get("Vulnerabilities", [])}
    missed = [p for p in plants() if (p[2], p[3], p[4]) not in found_v]
    patched = [p for p in plants() if any(k[0] == p[2] and k[2] == p[5] for k in found_v)]
    secrets = found(full_reports[0])
    missed_secrets = [p for p in planted if p not in secrets]
    pkg_licenses = [d for r in full_reports[0]["Results"] if r["Target"] == "Language Packages"
                    for d in r["Licenses"]]
    per_scan = [{
        "scanners": s, "device": d, "seconds": st["seconds"],
        "components": st["components"], "components_per_s": st["components"] / st["seconds"],
        "analyze_s": st["analyze.seconds"], "detect_s": st["detect.seconds"],
        "join_s": st["cve.join.seconds"], "dispatch_s": st["cve.dispatch.seconds"],
        "candidate_pairs": st["cve.candidate_pairs"], "rows": st["cve.resident_rows"],
        "dispatches": st["cve.dispatch_count"],
        "bounds_bytes_uploaded": st["cve.bounds_bytes_uploaded"],
        "files_walked": st["files_walked"], "files_scanned": st["files_scanned"],
        "launches": lc,
    } for s, d, _r, st, lc in scans]

    def same(reports):
        return all(r[k] == reports[0][k] for r in reports for k in ("Results", "Metadata"))

    result = {
        "phase": "fs-vuln", "lockfile_components": n_comp, "setup_s": setup_s,
        "db_load_s": load_s, "join_build_s": join_build_s, "scans": per_scan,
        "results": len(vuln_reports[0]["Results"]),
        "findings": len(found_v), "vuln_equal": same(vuln_reports),
        "full_equal": same(full_reports), "os": vuln_reports[0]["Metadata"].get("OS"),
        "planted": len(plants()), "missed": missed[:5], "patched_reported": patched[:5],
        "secrets_planted": planted, "secrets_missed": missed_secrets,
        "package_licenses": len(pkg_licenses), "card": card,
    }
    log(result)
    # for phase incremental (popped by main): the card's full scan and the DB
    result.update(full_results=full_reports[0]["Results"], full_launches=scans[3][4], db=db)
    check(result["vuln_equal"], "fs-vuln: Results or Metadata differ between card and CPU")
    check(result["full_equal"],
          "fs-vuln: vuln,secret,license Results or Metadata differ between card and CPU")
    check(not missed, f"fs-vuln: {len(missed)} planted vulnerable components not reported")
    check(not patched, f"fs-vuln: {len(patched)} components at their patched version reported")
    check(not missed_secrets, f"fs-vuln: planted secrets not reported: {missed_secrets}")
    check(len(pkg_licenses) >= FS_NODE_MODULES, "fs-vuln: package licenses not reported")
    check((result["os"] or {}).get("Family") == "debian", "fs-vuln: Metadata.OS missing")
    check([lc.get("verscmp", 0) for *_x, lc in scans] == [1, 1, 0, 1, 0],
          f"fs-vuln: verscmp launches per scan {[lc for *_x, lc in scans]}")
    check(per_scan[0]["bounds_bytes_uploaded"] > 0, "fs-vuln: the first scan uploaded no bounds")
    check(per_scan[1]["bounds_bytes_uploaded"] == 0, "fs-vuln: the second scan uploaded bounds")
    check(all(scans[3][4].get(k, 0) > 0 for k in ("prefilter", "anchored")),
          f"fs-vuln: the matcher was not launched by the full scan: {scans[3][4]}")
    check(len(captured) == 5, f"fs-vuln: {len(captured)} dispatches captured, want 5")
    inst_np, bounds_dev, a_np, b_np, ops_np = captured[0]
    inst = torch.from_numpy(inst_np).cuda()
    a_idx, b_idx, ops = (torch.from_numpy(x).cuda() for x in (a_np, b_np, ops_np))
    got = check_ops_gather(inst, bounds_dev, a_idx, b_idx, ops)
    want = check_ops_gather_plain(inst, bounds_dev, a_idx, b_idx, ops)
    torch.cuda.synchronize()
    result["kernel_equal"] = torch.equal(got, want)
    result["kernel_shape"] = [len(ops_np), int(inst_np.shape[1])]
    log({"phase": "fs-vuln-kernel", "equal": result["kernel_equal"],
         "shape": result["kernel_shape"], "vulnerable_rows": int(want.sum())})
    check(result["kernel_equal"],
          "verscmp kernel disagrees with its plain version on the fs-vuln dispatch")
    return result


# the kernels an unchanged incremental rescan must not launch: the secret
# feed's and the license pass's
INCR_FEED_KERNELS = ("prefilter", "anchored", "decompress", "gram_gate", "bytes_gate",
                     "bytes_score")
# the fs-vuln tree's units are about 2,100 (a directory each, node_modules'
# packages included)
INCR_MIN_UNITS = 2_000
# license texts put in the edited unit, src/, of the phase's copy: enough for
# the classifier's device path (DEVICE_MIN_TEXTS), and the fused gate sees
# them in the secret feed, so every feed and license kernel has work there
INCR_LICENSES = DEVICE_MIN_TEXTS
INCR_COUNTS = ("units_total", "units_analyzed", "files_stat_reused", "files_git_reused",
               "files_hashed", "files_walked", "files_scanned")


def phase_incremental(root: Path, fs_tree: Path, db, db_dir: Path, full_results: list,
                      full_launches: dict, card: str, device: str = "cuda") -> dict:
    """Incremental scanning on a git copy of the fs-vuln tree with
    ``vuln,secret,license`` on the card, one fs scan cache for every step
    (launch counters to 0 just before each scan, read just after): (1) a cold
    ``incremental`` scan, whose ``Results`` and launches equal phase
    ``fs-vuln``'s full card scan's beside the license texts that the phase
    adds to ``src/``, every feed and license kernel launched; (2) an
    unchanged ``since_last`` scan: no unit analyzed, none of the feed's or
    the license kernels launched, the same ``Results``; (3) a secret planted
    in ``src/module_0.py`` and committed, then a ``since_last`` scan: one
    unit analyzed, the new finding there and every other finding as before,
    the manifest recorded at the new commit, and the feed and license
    kernels launched as often as by a full scan of ``src`` alone; (4)
    every mtime touched (a fresh checkout) and ``diff_base="HEAD"``: every
    file keyed from git, no unit analyzed, no feed launch; (5)
    ``cli.main(["watch", ..., "--watch-count", "1"])`` on the same cache:
    (4)'s filtered ``Results``, no feed launch (a second tick over the
    unchanged tree would repeat (2); the CPU tests hold several ticks
    against the JAX ``watch``). ``device="cpu"`` is a dry
    run: the plain versions launch no kernel, so only the feed's absence is
    checked."""
    from trivy_tpu_torch.cache import new_cache
    from trivy_tpu_torch.incremental import IncrementalOptions
    from trivy_tpu_torch.result import FilterOptions, filter_report

    t_phase = time.perf_counter()
    tree = root / "tree"
    # hard links: the edit below writes a new file, so fs_tree keeps its own
    shutil.copytree(fs_tree, tree, copy_function=os.link)
    licenses = sorted(FULL_TEXTS)[:INCR_LICENSES]
    for name in licenses:
        (tree / "src" / f"LICENSE-{name}").write_text(FULL_TEXTS[name])
    copy_s = time.perf_counter() - t_phase
    git_commit_tree(tree)
    git_s = time.perf_counter() - t_phase - copy_s
    cache = new_cache("fs", str(root / "cache"))
    steps = []

    def scan(step: str, **incr) -> dict:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        report, stats = cli.scan_fs(str(tree), scanners=("vuln", "secret", "license"), db=db,
                                    device=device, cache=cache,
                                    incremental=IncrementalOptions(enabled=True, **incr))
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        steps.append({"step": step, "seconds": seconds, "scan_seconds": stats["seconds"],
                      "detect_s": stats["detect.seconds"], "components": stats["components"],
                      **{k: stats[k] for k in INCR_COUNTS}, "launches": launches})
        return {"report": report, "doc": report.to_dict(), "stats": stats,
                "launches": launches}

    cold = scan("cold")
    warm = scan("unchanged", since_last=True)
    rid = sorted(SAMPLES)[3]
    target = tree / "src" / "module_0.py"
    data = target.read_bytes()
    data += b"" if data.endswith(b"\n") else b"\n"
    line = data.count(b"\n") + 1
    target.unlink()
    target.write_bytes(data + SAMPLES[rid].encode() + b"\n")
    git(tree, "commit", "-qam", "edit")  # pushed: the manifest records this commit
    edited = scan("one-edit", since_last=True)
    # the edited unit alone, in a full scan: what its analysis launches
    solo = root / "solo"
    shutil.copytree(tree / "src", solo / "src", copy_function=os.link)
    LAUNCHES.clear()
    cli.scan_fs(str(solo), scanners=("vuln", "secret", "license"), db=db, device=device)
    solo_launches = dict(LAUNCHES)
    stamp = time.time_ns() + 10**9
    for d, dirs, names in os.walk(tree):
        dirs[:] = [x for x in dirs if x != ".git"]
        for n in names:
            os.utime(os.path.join(d, n), ns=(stamp, stamp))
    diffed = scan("diff-base", diff_base="HEAD")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = root / "watch.json"
    load_db = cli.load_db
    cli.load_db = lambda *a: db  # the loaded DB, not a second load of db_dir
    try:
        rc = cli.main(["watch", "--scanners", "vuln,secret,license", "--device", device, "-q",
                       "--db-repository", str(db_dir), "--cache-dir", str(root / "cache"),
                       "--format", "json", "-o", str(out), "--watch-interval", "0.1",
                       "--watch-count", "1", str(tree)])
    finally:
        cli.load_db = load_db
    watch_s = time.perf_counter() - t0
    watch_launches = dict(LAUNCHES)
    watched = json.loads(out.read_text()) if out.exists() else {}
    want = filter_report(Report.from_dict(diffed["doc"]), FilterOptions()).to_dict()

    old_secrets, new_secrets = found(cold["doc"]), found(edited["doc"])

    def others(doc: dict) -> list:
        return [r for r in doc["Results"] if r["Class"] != "secret"]

    # the tree of fs-vuln has no license file: the added texts are the only ones
    file_licenses = {(lic["FilePath"], lic["Name"]) for r in cold["doc"]["Results"]
                     if r["Class"] == "license-file" for lic in r["Licenses"]}

    result = {
        "phase": "incremental", "copy_s": copy_s, "git_s": git_s, "steps": steps,
        "watch_s": watch_s, "watch_launches": watch_launches, "card": card,
        # the OS result's target names the artifact: the copy's path aside
        "cold_equals_full": [r for r in renamed(cold["doc"], str(fs_tree))
                             if r["Class"] != "license-file"] == full_results,
        "licenses_missed": sorted({(f"src/LICENSE-{k}", k) for k in licenses}
                                  - file_licenses),
        "solo_launches": solo_launches,
        "unchanged_equal": warm["doc"]["Results"] == cold["doc"]["Results"],
        "new_secret": sorted(new_secrets - old_secrets),
        "others_equal": others(edited["doc"]) == others(cold["doc"]),
        "diff_equal": diffed["doc"]["Results"] == edited["doc"]["Results"],
        "watch_equal": watched.get("Results") == want["Results"],
        "seconds": time.perf_counter() - t_phase,
    }
    log(result)
    by = {s["step"]: s for s in steps}
    check(result["cold_equals_full"], "incremental: the cold scan's Results differ from fs-vuln's")
    check(by["cold"]["units_analyzed"] == by["cold"]["units_total"] > INCR_MIN_UNITS,
          f"incremental: the cold scan analyzed {by['cold']['units_analyzed']} units")
    check(not result["licenses_missed"],
          f"incremental: license texts not reported: {result['licenses_missed']}")
    on_card = device != "cpu"
    feed = {k: cold["launches"].get(k, 0) for k in INCR_FEED_KERNELS}
    check(not on_card or all(feed.values()),
          f"incremental: the cold scan left feed or license kernels unlaunched: {feed}")
    check(cold["launches"].get("verscmp", 0) == full_launches.get("verscmp", 0),
          f"incremental: the cold scan's verscmp launches {cold['launches']}, the full "
          f"scan's {full_launches}")
    for step in ("unchanged", "diff-base"):
        s = by[step]
        check(s["units_analyzed"] == 0, f"incremental: {step} analyzed {s['units_analyzed']}")
        check(not any(s["launches"].get(k, 0) for k in INCR_FEED_KERNELS),
              f"incremental: {step} launched feed kernels {s['launches']}")
        check(not on_card or s["launches"].get("verscmp", 0) == 1,
              f"incremental: {step} launched verscmp {s['launches'].get('verscmp', 0)} times")
    check(result["unchanged_equal"], "incremental: the unchanged rescan's Results differ")
    check(by["unchanged"]["files_stat_reused"] == by["unchanged"]["files_walked"],
          "incremental: the unchanged rescan read files")
    check(by["one-edit"]["units_analyzed"] == 1,
          f"incremental: the edit re-analyzed {by['one-edit']['units_analyzed']} units")
    edit_feed = {k: edited["launches"].get(k, 0) for k in INCR_FEED_KERNELS}
    check(edit_feed == {k: solo_launches.get(k, 0) for k in INCR_FEED_KERNELS}
          and (not on_card or all(edit_feed.values())),
          f"incremental: the edit launched {edit_feed}, a full scan of its unit "
          f"{solo_launches}")
    check(result["new_secret"] == [("src/module_0.py", rid, line)],
          f"incremental: the planted secret: {result['new_secret']}")
    check(old_secrets <= new_secrets, "incremental: a finding went missing after the edit")
    check(result["others_equal"], "incremental: the edit changed findings beside its secret")
    check(by["diff-base"]["files_git_reused"] == by["diff-base"]["files_walked"],
          f"incremental: --diff-base git-reused {by['diff-base']['files_git_reused']} of "
          f"{by['diff-base']['files_walked']} files")
    check(result["diff_equal"], "incremental: the diff-base scan's Results differ")
    check(rc == 0 and result["watch_equal"], f"incremental: watch exited {rc} or differs")
    check(not any(watch_launches.get(k, 0) for k in INCR_FEED_KERNELS),
          f"incremental: watch launched feed kernels {watch_launches}")
    return result


# the counters of a scan that took a rung of the ladder: a batch retried or
# split, a run or a license batch or a CVE join that fell back to the host
LADDER_KEYS = ("batch_retries", "batch_splits", "degraded", "scan.degraded", "license.degraded",
               "cve.degraded")
# rows per batch of the ladder phase's in-process runs: the fs-vuln tree's
# few MiB of secret-scanned bytes then make enough batches for at=2 and at=3
LADDER_BATCH = 64
# the real-OOM child caps its device memory this far under the peak of its
# unfaulted scan (32 MiB reserved on the 16 MiB subset: the 16 MiB rows
# beside a 14 MiB wire and a 2 MiB segment of small blocks): the full batch
# no longer fits, a half batch does (16 MiB reserved under the cap). Caps
# of 22 and 26 MiB both split once and passed on an H100; 8 MiB under the
# peak puts the cap of 24 MiB midway, 8 MiB from either outcome
OOM_CUT = 8 << 20
# scans checked by unfaulted(); the ladder phase sets "off" while it faults
UNFAULTED = {"scans": 0, "off": False}


def unfaulted(scan):
    """``scan`` (``cli.scan_fs``, ``scan_image``, ``scan_vm``, ``scan_sbom``
    or ``scan_fleet``) checked to take no rung of the ladder: no batch retried
    or split, nothing degraded, no ``Degraded`` report. ``main`` installs it
    over each of them in ``cli`` (``cli.main`` calls them too), so a kernel
    that only "works" through the host fails whichever phase runs it; the
    ladder phase turns the check off while it faults on purpose."""

    @functools.wraps(scan)
    def run(*args, **kwargs):
        report, stats = scan(*args, **kwargs)
        if not UNFAULTED["off"]:
            UNFAULTED["scans"] += 1
            walked = {k: stats.get(k, 0) for k in LADDER_KEYS}
            check(not any(walked.values()) and not report.degraded,
                  f"an unfaulted scan took the ladder: {walked}, Degraded {report.degraded}")
        return report, stats

    return run


# the real-OOM run, in its own process (argv: tree, output, cut): an
# unfaulted scan, then the same scan with the process's device memory capped
# at that scan's peak less the cut (the cached blocks released first, so the
# second scan reserves anew under the cap)
OOM_CHILD = """
import json, sys, torch
from trivy_tpu_torch import cli
torch.cuda.set_device(0)
base, base_stats = cli.scan_fs(sys.argv[1], device="cuda")
peak = torch.cuda.max_memory_reserved()
torch.cuda.empty_cache()
torch.cuda.reset_peak_memory_stats()
limit = peak - int(sys.argv[3])
torch.cuda.set_per_process_memory_fraction(limit / torch.cuda.get_device_properties(0).total_memory)
report, stats = cli.scan_fs(sys.argv[1], device="cuda")
with open(sys.argv[2], "w") as f:
    json.dump({"base": base.to_dict(), "base_stats": base_stats, "report": report.to_dict(),
               "stats": stats, "peak_bytes": peak, "limit_bytes": limit,
               "max_reserved": torch.cuda.max_memory_reserved()}, f)
"""


def write_license_ladder(root: Path) -> None:
    """Eight license texts and four wide ones (two width rungs, so more than
    one license dispatch), and a source file with a secret."""
    texts = [FULL_TEXTS[k] for k in sorted(FULL_TEXTS)[:8]]
    texts += [FULL_TEXTS["MIT"] + " more filler words here " * 300] * 4
    for i, t in enumerate(texts):
        (root / f"lic{i}").mkdir(parents=True)
        (root / f"lic{i}" / "LICENSE").write_text(t)
    (root / "src").mkdir()
    (root / "src" / "cfg.py").write_text(f"token = '{SAMPLES['github-pat']}'\n")


def phase_ladder(root: Path, fs_tree: Path, e2e_tree: Path, cve_dir: Path, card: str) -> dict:
    """The scan ladder on the card, each run through ``cli.main`` with a
    fresh cache (launch counters to 0 just before, read just after) and
    held against the same tree's unfaulted card scan: a dispatch retried,
    a fetch retried, an OOM-shaped dispatch split, the real allocator OOM
    in a child process, a dead device (degrading to the host on the CPU,
    failing on the card with a bundle that ``debug`` renders), the license
    stage and the CVE join dead (the same), an encoder that raises, and
    ``--timeout 1``."""
    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    runs: list[dict] = []
    totals: dict[str, int] = {}

    def scan(tag: str, target: Path, device: str, *extra: str, command=("fs", "--scanners",
                                                                         "secret")):
        out, st = root / f"{tag}.json", root / f"{tag}.stats.json"
        LAUNCHES.clear()
        t0 = time.perf_counter()
        rc = cli.main([*command, "--format", "json", "-o", str(out), "--stats-out", str(st),
                       "--device", device, "--cache-dir", str(root / f"cache-{tag}"), "-q",
                       *extra, str(target)])
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n
        doc = json.loads(out.read_text()) if out.exists() else None
        stats = json.loads(st.read_text()) if st.exists() else {}
        runs.append({"run": tag, "rc": rc, "seconds": seconds,
                     **{k: stats.get(k, 0) for k in LADDER_KEYS},
                     "batches": stats.get("batches", 0),
                     "Degraded": bool(doc and doc.get("Degraded")), "launches": launches})
        return rc, doc, stats

    def loud(tag: str, target: Path, *extra: str, **kw) -> str:
        """A faulted card scan that must raise: the fault's message."""
        t0 = time.perf_counter()
        try:
            scan(tag, target, "cuda", *extra, **kw)
        except faults.InjectedFault as e:
            launches = dict(LAUNCHES)
            for k, n in launches.items():
                totals[k] = totals.get(k, 0) + n
            runs.append({"run": tag, "seconds": time.perf_counter() - t0,
                         "raised": f"{type(e).__name__}: {e}", "launches": launches})
            return str(e)
        return ""

    def bundle(kind: str, bundles: Path, text: str) -> None:
        """One ``kind`` bundle in ``bundles``, whose verdict holds ``text``
        and that ``debug`` renders with exit 0."""
        found_bundles = sorted(bundles.glob(f"bundle-*-{kind}.json.gz"))
        check(len(found_bundles) == 1, f"ladder (e): {kind} bundles {found_bundles}")
        rendered = io.StringIO()
        with contextlib.redirect_stdout(rendered):
            rc_debug = cli.main(["debug", str(found_bundles[0])])
        verdict = recorder.read_bundle(str(found_bundles[0]))["verdict"]
        check(rc_debug == 0 and text in verdict,
              f"ladder (e): debug exited {rc_debug}; verdict {verdict!r}")

    UNFAULTED["off"] = True
    default_batch = secret_scanner.BATCH
    secret_scanner.BATCH = LADDER_BATCH
    try:
        _, base, s_base = scan("base", fs_tree, "cuda")
        check(s_base["batches"] >= 3 and not any(s_base.get(k) for k in LADDER_KEYS),
              f"ladder: the base scan made {s_base['batches']} batches or took the ladder")
        # (a) a dispatch retried, (b) a fetch retried, (c) an OOM split
        for tag, spec, key in (("a-dispatch", "device.dispatch@d0:at=2", "batch_retries"),
                               ("b-fetch", "device.fetch@d0:at=3", "batch_retries"),
                               ("c-oom", "device.dispatch@d0:at=1:error=oom", "batch_splits")):
            rc, doc, st = scan(tag, fs_tree, "cuda", "--fault-inject", spec)
            check(rc == 0 and doc["Results"] == base["Results"] and "Degraded" not in doc,
                  f"ladder ({tag}): Results differ from the unfaulted scan or Degraded")
            check(st[key] == 1 and st["degraded"] == 0,
                  f"ladder ({tag}): {key} {st[key]}, degraded {st['degraded']}")
        # (e) a dead device: on the CPU the host path with the card's
        # findings and a bundle; on the card a failure and a bundle, with
        # the fallback on or off (the card's work never ends on the host)
        dead = ("--fault-inject", "device.dispatch:times=-1")
        bundles = root / "bundles"
        try:
            rc, on_cpu, st = scan("e-cpu-dead", fs_tree, "cpu", *dead,
                                  "--debug-dir", str(bundles / "cpu"))
            check(rc == 0 and on_cpu.get("Degraded") is True and st["degraded"] == 1
                  and on_cpu["Results"] == base["Results"],
                  "ladder (e): the dead-device CPU scan did not complete degraded with the "
                  "card's Results")
            bundle("degraded-completion", bundles / "cpu", "fault device.dispatch")
            for tag, extra in (("e-dead", ()), ("e-no-fallback", ("--no-host-fallback",))):
                msg = loud(tag, fs_tree, *dead, "--debug-dir", str(bundles / tag), *extra)
                check(msg == "injected fault at device.dispatch[d0] hit 3",
                      f"ladder ({tag}): the dead-device card scan did not fail after its "
                      f"retries: {msg!r}")
                bundle("terminal-failure", bundles / tag, "fault device.dispatch")
        finally:
            recorder._STATE.debug_dir = ""  # the flag's destination is process-wide
        # (f) the license stage dead in a fused scan: degraded on the CPU,
        # a failure on the card
        write_license_ladder(root / "lic")
        fused = ("fs", "--scanners", "secret,license", "--license-full")
        lic_dead = ("--fault-inject", "device.dispatch@license:at=2:times=-1")
        _, lic_base, _ = scan("f-base", root / "lic", "cuda", command=fused)
        rc, lic, st = scan("f-cpu-license", root / "lic", "cpu", *lic_dead, command=fused)
        check(rc == 0 and st["license.degraded"] >= 1 and st["degraded"] == 0
              and lic["Results"] == lic_base["Results"] and lic.get("Degraded") is True,
              f"ladder (f): license.degraded {st['license.degraded']}, or the CPU's findings "
              "differ from the card's")
        msg = loud("f-license", root / "lic", *lic_dead, command=fused)
        check("device.dispatch[license]" in msg, f"ladder (f): the card scan raised {msg!r}")
        # (g) the CVE join dead in an sbom scan: a failure on the card
        sbom = ("sbom", "--db-repository", str(cve_dir / "db"))
        msg = loud("g-cve", cve_dir / "bom.json", "--fault-inject",
                   "device.dispatch@cve:times=-1", command=sbom)
        check("device.dispatch[cve]" in msg, f"ladder (g): the card scan raised {msg!r}")
        # (h) an encoder that raises: the batches ship raw
        emit = SlabCodec.emit

        def broken_emit(*args, **kwargs):
            raise RuntimeError("encoder broke")

        SlabCodec.emit = broken_emit
        try:
            rc, raw, st = scan("h-encoder", fs_tree, "cuda", "--secret-compress", "on")
        finally:
            SlabCodec.emit = emit
        check(rc == 0 and raw["Results"] == base["Results"] and st["batches_compressed"] == 0
              and st["batches_raw_fallback"] == st["batches"] > 0,
              "ladder (h): a raising encoder did not ship every batch raw")
        # (i) --timeout 1 on the e2e tree
        rc, _, _ = scan("i-timeout", e2e_tree, "cuda", "--timeout", "1")
        check(rc == 1, f"ladder (i): --timeout 1 exited {rc}")
    finally:
        secret_scanner.BATCH = default_batch
        UNFAULTED["off"] = False
        faults.clear()
    # (d) the real allocator OOM, in a child process at full batches
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", OOM_CHILD, str(e2e_tree / "sub16"),
                           str(root / "d-oom.json"), str(OOM_CUT)],
                          cwd=REPO, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"ladder (d): the OOM child exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    child = json.loads((root / "d-oom.json").read_text())
    st, st0 = child["stats"], child["base_stats"]
    runs.append({"run": "d-oom", "rc": proc.returncode, "seconds": child_s,
                 **{k: st.get(k, 0) for k in LADDER_KEYS}, "batches": st["batches"],
                 "base_batches": st0["batches"], "Degraded": child["report"].get("Degraded", False),
                 "peak_bytes": child["peak_bytes"], "limit_bytes": child["limit_bytes"],
                 "max_reserved": child["max_reserved"]})
    check(not any(st0.get(k) for k in LADDER_KEYS) and not child["base"].get("Degraded"),
          "ladder (d): the child's unfaulted scan took the ladder")
    check(st["batch_splits"] >= 1 and st["degraded"] == 0 and not child["report"].get("Degraded"),
          f"ladder (d): batch_splits {st['batch_splits']}, degraded {st['degraded']}: "
          f"{proc.stderr[-2000:]}")
    check(child["report"]["Results"] == child["base"]["Results"],
          "ladder (d): the OOM-split scan's Results differ from the unfaulted scan")
    result = {"phase": "ladder", "seconds": time.perf_counter() - t_phase, "runs": runs,
              "launches": totals, "card": card}
    log(result)
    return result


# the spans tests/test_torch_trace_cli.py expects on its CPU scan, and the
# CVE join's (its small tree stays below the join's batch threshold)
# phase mesh: the round-robin, the breaker and the mesh over one card
# twice, in 128-row (2 MiB) batches so that the 16 MiB subset makes enough
# batches for every dispatch index, and for the breaker to see a dead d1
# fail its threshold of times
MESH_DEVICES = ("cuda:0", "cuda:0")
MESH_BATCH = 128
# corpus shards whose slabs the scorer is held at: 118 licenses make
# Ls = 59 at m = 2 and Ls = 30 at m = 4 (the last shard padded)
MESH_SHARDS = {2: 59, 4: 30}
MESH_SCORE_WIDTHS = (4096, 16384)
# the legacy int32 scorer's six dispatch shapes [B, T] at bench.py:757's
# sizes (tools/legacy_scorer_shapes.py)
LEGACY_SHAPES = ((32, 256), (64, 512), (64, 1024), (8, 2048), (16, 4096), (8, 8192))


def legacy_rows(rng: np.random.Generator, keys: np.ndarray, B: int, T: int) -> np.ndarray:
    """``[B, T]`` int32 gram rows as ``pack_gram_rows`` lays them out: each
    row a sorted run of distinct keys, half drawn from the corpus's own key
    column and half random, longer than ``T / 2`` (the row length bucket
    below), then ``PAD_KEY``."""
    real = keys[keys != PAD_KEY]
    out = np.full((B, T), PAD_KEY, np.int32)
    for i in range(B):
        n = int(rng.integers(T // 2 + 1, T + 1))
        k = np.unique(np.concatenate([
            rng.choice(real, n // 2),
            rng.integers(-(1 << 31), (1 << 31) - 2, n - n // 2, dtype=np.int64).astype(np.int32)]))
        out[i, : len(k)] = k
    return out


def breaker_open(label: str) -> float | None:
    """The process-global breaker gauge's row for ``label``."""
    line = re.search(rf'^trivy_tpu_device_breaker_open\{{device="{label}"\}} (\S+)$',
                     obs_metrics.REGISTRY.render(), re.M)
    return float(line.group(1)) if line else None


def phase_mesh(root: Path, e2e_tree: Path, cut_results: list, base: bytes, seed: int,
               card: str) -> dict:
    """Multi-device dispatch over ``[cuda:0, cuda:0]`` (this machine has one
    card: no number here is a multi-card number). (a) the secret scan of
    the e2e tree's 16 MiB ``sub16`` subset (the feed phase's) through
    ``cli.scan_fs`` with round-robin scanner options against the
    single-dispatch card scan and the subset's ``--device cpu`` Results, both dispatch indices taking batches; (b) the
    same with ``device.dispatch@d1:times=-1``: the breaker opens on d1, the
    Results stay, nothing degrades; (c) both indices dead: the scan fails on
    the card; (d) a ``data = 2`` mesh: the Results, compression off, and
    ``hit_counts_psum`` against the plain count; (e) the classifier with its
    corpus over ``model = 2`` against one shard, and ``bytes_score.cu`` at
    the shard widths Ls = 59 and 30 against its plain version and
    reassembled against m = 1; (f) the legacy int32 scorer (PyTorch on the
    card) at m = 1 and 2 against its CPU version at the six shapes, timed
    beside its bound and ``embedding_bag``'s sum."""
    from trivy_tpu_torch import obs
    from trivy_tpu_torch.ops import ngram_score as ng
    from trivy_tpu_torch.parallel.mesh import PerDevice, get_mesh, hit_counts_psum

    t_phase = time.perf_counter()
    cut = e2e_tree / "sub16"
    cut_bytes = sum(f.stat().st_size for f in cut.rglob("*") if f.is_file())
    two = list(MESH_DEVICES)
    dev = two[0]
    runs = {}

    def scan(tag: str, **opts) -> tuple[list, dict]:
        LAUNCHES.clear()
        with obs.scan_context(name=f"mesh-{tag}", enabled=True) as ctx:
            t0 = time.perf_counter()
            report, stats = cli.scan_fs(str(cut), device=dev, batch_size=MESH_BATCH, **opts)
            secs = time.perf_counter() - t0
        results = [r.to_dict() for r in report.results]
        runs[tag] = row = {
            "seconds": secs, "MBps": cut_bytes / secs / 1e6, "batches": stats["batches"],
            "launches": dict(LAUNCHES),
            "batches_by_index": {f"d{i}": ctx.counters.get(f"mesh.d{i}.batches", 0)
                                 for i in range(len(two))},
            "batch_retries": stats["batch_retries"], "degraded": stats["degraded"],
            "batches_compressed": stats["batches_compressed"],
            "results_equal_cpu": results == cut_results,
        }
        log({"phase": "mesh-run", "tag": tag, **row})
        return results, stats

    # (a) round-robin against single dispatch and the CPU
    single, _ = scan("single")
    rr, _ = scan("round-robin", dispatch="round_robin", devices=two)
    a = runs["round-robin"]
    check(single == rr == cut_results, "mesh: round-robin Results differ from single or CPU")
    check(all(n > 0 for n in a["batches_by_index"].values()),
          f"mesh: a dispatch index took no batch: {a['batches_by_index']}")
    check(sum(a["batches_by_index"].values()) == a["launches"].get("prefilter", 0) == a["batches"],
          f"mesh: batches by index {a['batches_by_index']} against launches {a['launches']}")
    # (b) d1 dead: the breaker opens on it, d0 takes the rest
    check(breaker_open("d1") in (None, 0.0), "mesh: d1's breaker was open before the fault")
    UNFAULTED["off"] = True
    faults.configure("device.dispatch@d1:times=-1")
    try:
        dead1, _ = scan("d1-dead", dispatch="round_robin", devices=two)
    finally:
        faults.clear()
        UNFAULTED["off"] = False
    b = runs["d1-dead"]
    check(dead1 == cut_results and b["degraded"] == 0 and breaker_open("d1") == 1.0,
          f"mesh: d1 dead: {b}, gauge {breaker_open('d1')}")
    # (c) every index dead: the scan fails on the card, it does not degrade
    UNFAULTED["off"] = True
    faults.configure("device.dispatch:times=-1")
    raised = None
    try:
        scan("all-dead", dispatch="round_robin", devices=two)
    except faults.InjectedFault as e:
        raised = str(e)
    finally:
        faults.clear()
        UNFAULTED["off"] = False
    check(raised is not None, "mesh: a scan with every device dead did not fail on the card")
    # (d) a data = 2 mesh: compression off, two row blocks per batch
    mesh2 = get_mesh(devices=two)
    sharded, _ = scan("mesh", mesh=mesh2)
    d = runs["mesh"]
    check(sharded == cut_results and d["batches_compressed"] == 0,
          f"mesh: the mesh scan: {d}")
    check(d["launches"].get("prefilter", 0) == 2 * d["batches"],
          f"mesh: {d['launches']} for {d['batches']} batches of two row blocks")
    compiled = compile_rules(SecretScanner().rules)
    rng = np.random.default_rng(seed + 16)
    rows = sample_rows(rng, np.frombuffer(base, np.uint8), sorted(SAMPLES.values()), MESH_BATCH,
                       CHUNK_LEN, max(64, compiled.span + 1))
    counts = hit_counts_psum(PerDevice(lambda d: build_match_fn_cuda(compiled, CHUNK_LEN,
                                                                      device=d)), mesh2)(rows)
    plain = match_plain(match_tables(compiled, True), torch.from_numpy(rows).to(dev)).sum(
        0, dtype=torch.int32)
    psum = {"equal": bool(torch.equal(counts, plain)), "hits": int(plain.sum()),
            "max_abs_err": int((counts - plain).abs().max())}
    check(psum["equal"] and psum["hits"] > 0, f"mesh: hit_counts_psum {psum}")

    # (e) the classifier over model = 2, and the scorer at the shard widths
    rng_t = random.Random(seed + 17)
    texts = [FULL_TEXTS[k] for k in sorted(FULL_TEXTS)]
    texts += [t[:600] for t in texts] + [
        base[o : o + 4096].decode() + (HEADERS[".py"] if i % 2 else "")
        for i, o in enumerate(rng_t.randrange(0, len(base) - 4096) for _ in range(20))]
    lic_mesh = get_mesh(devices=two, model=2)
    clf_m = LicenseClassifier(mesh=lic_mesh)
    clf_1 = LicenseClassifier(device=dev)
    got = [[(f.name, f.confidence) for f in fs] for fs in clf_m.classify_batch(texts)]
    want = [[(f.name, f.confidence) for f in fs] for fs in clf_1.classify_batch(texts)]
    check(got == want and sum(map(len, got)) >= 40,
          f"mesh: model = 2 findings differ from m = 1 ({sum(map(len, got))} findings)")
    one = clf_1._device_scorer()._score
    L = clf_1._device_scorer().table.n_licenses
    shard_rows_ = {}
    scorer_out = {}
    for m, ls in MESH_SHARDS.items():
        table = clf_1.corpus_table(m)
        check(table.lic_per_shard == ls, f"mesh: m = {m} gives Ls = {table.lic_per_shard}")
        for width in MESH_SCORE_WIDTHS:
            R = ng.rows_per_dispatch(width)
            x = shard_rows_.setdefault(width, torch.from_numpy(
                scorer_rows(rng_t, base, width, R)).to(dev))
            cap = DeviceBytesScorer.gram_cap(width)
            fw1, ph1, nu1 = one(x, cap)
            parts, errs, equal = [], [], True
            for s in range(m):
                sc = CudaBytesScorer(table.lut, *table.shard(s), table.p1, table.p2, table.hash_p,
                                     table.ngram, dev)
                fw, ph, nu = sc(x, cap)
                pfw, pph, pnu = bytes_score_plain(x, sc.lut, sc.keys, sc.credit, sc.p1, sc.p2,
                                                  sc.hash_p, effective_cap(cap, width), sc.ngram)
                equal &= bool(torch.equal(ph, pph) and torch.equal(nu, pnu)
                              and torch.allclose(fw, pfw, rtol=SCORE_RTOL, atol=0))
                errs.append(float((fw - pfw).abs().max()))
                parts.append((fw, ph))
                if s == 0:
                    ms, _, _ = time_cuda(lambda t, sc=sc: sc(t, cap), [x])
                    plain_ms, _, _ = time_cuda(lambda t, sc=sc: bytes_score_plain(
                        t, sc.lut, sc.keys, sc.credit, sc.p1, sc.p2, sc.hash_p,
                        effective_cap(cap, width), sc.ngram), [x], rounds=1)
                    bound, _, _ = score_bound_ms(sc, [x], effective_cap(cap, width))
            fw_m = torch.cat([p[0] for p in parts], 1)[:, :L]
            ph_m = torch.cat([p[1] for p in parts], 1)[:, :L]
            reassembled = bool(torch.allclose(fw_m, fw1[:, :L], rtol=SCORE_RTOL, atol=0)
                               and torch.equal(ph_m, ph1[:, :L]))
            scorer_out[f"m{m}_{width}"] = {
                "ls": ls, "shape": [R, width], "equal_plain": equal, "max_abs_err": max(errs),
                "reassembled_equal_m1": reassembled, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes"}
            check(equal and reassembled, f"mesh: bytes_score at m = {m}, width {width}: "
                                         f"{scorer_out[f'm{m}_{width}']}")

    # (f) the legacy int32 scorer on the card against its CPU version
    clf_1._build_scoring()
    tables = {m: ng.build_corpus_table(clf_1.licenses, clf_1._full_keys, clf_1._full_weights,
                                       clf_1._phrase_keys, clf_1._phrase_short, model_shards=m)
              for m in (1, 2)}
    scorers = {
        "m1": (ng.DeviceScorer(tables[1], device=dev), ng.DeviceScorer(tables[1], device="cpu")),
        "m2": (ng.DeviceScorer(tables[2], mesh=lic_mesh),
               ng.DeviceScorer(tables[2], mesh=get_mesh(devices=["cpu", "cpu"], model=2))),
    }
    rng_l = np.random.default_rng(seed + 18)
    Ku, two_ls = tables[1].credit.shape[1:]
    keys_d, credit_d = scorers["m1"][0].corpus_device
    legacy = []
    for B, T in LEGACY_SHAPES:
        rows = legacy_rows(rng_l, tables[1].keys[0], B, T)
        x = torch.from_numpy(rows).to(dev)
        entry = {"shape": [B, T]}
        for tag, (on_card, on_cpu) in scorers.items():
            fw, ph = on_card(x)
            g = on_card.gate(x)
            cfw, cph = on_cpu(rows)
            cg = on_cpu.gate(rows)
            ok = (torch.equal(ph.cpu(), cph) and torch.equal(g.cpu(), cg)
                  and torch.allclose(fw.cpu(), cfw, rtol=SCORE_RTOL, atol=0))
            entry[f"{tag}_equal_cpu"] = bool(ok)
            entry[f"{tag}_max_abs_err"] = float((fw.cpu() - cfw).abs().max())
            entry[f"{tag}_ms"], _, _ = time_cuda(lambda t, s=on_card: s(t), [x])
            entry[f"{tag}_gate_ms"], _, _ = time_cuda(lambda t, s=on_card: s.gate(t), [x])
            check(ok, f"mesh: legacy scorer {tag} at {[B, T]} differs from its CPU version")
        idx = torch.searchsorted(keys_d.reshape(-1), x).clamp_(max=Ku - 1)
        w = (keys_d.reshape(-1)[idx] == x).float()
        cred = credit_d.reshape(Ku, -1)
        entry["library_ms"], _, _ = time_cuda(lambda t: torch.nn.functional.embedding_bag(
            idx, cred, mode="sum", per_sample_weights=w), [x])
        score_bytes = B * T * 4 + Ku * 4 + Ku * two_ls * 4 + 2 * B * (two_ls // 2) * 4
        entry["bound_ms"] = score_bytes / HBM_BYTES_PER_S * 1e3
        entry["gate_bound_ms"] = (B * T * 4 + Ku * 4 + B * 4) / HBM_BYTES_PER_S * 1e3
        entry["bound_by"] = "bytes"
        legacy.append(entry)
        log({"phase": "mesh-legacy", **entry, "card": card})
    result = {
        "phase": "mesh", "devices": two, "cut_bytes": cut_bytes, "runs": runs,
        "all_dead_raised": raised, "hit_counts_psum": psum, "bytes_score": scorer_out,
        "license_findings": sum(map(len, got)), "seconds": time.perf_counter() - t_phase,
        "card": card,
    }
    log(result)
    return result


TRACE_SPANS = (
    "secret.feed_wait", "secret.dispatch", "secret.prefilter", "secret.confirm",
    "secret.assemble", "license.dispatch", "license.device_wait", "license.finalize",
    "driver.apply_layers", "driver.detect_vulns", "fs.read_wait", "fs.batch_analyze",
    "walk.next", "cve.join", "cve.dispatch",
)
# a span of each thread of the secret feed: feeder, device worker, confirm pool
TRACE_TRACKS = {"feeder": "secret.assemble", "worker": "secret.feed_wait",
                "confirm": "secret.confirm"}
TRACE_EXPORTS = ("trace", "metrics", "profile", "timeseries")
TRACE_LICENSE_FILES = 16  # license files added to the fs-vuln tree for the trace phase


def profiled_kernel_ms(run) -> tuple[object, float, int]:
    """``run()`` under ``torch.profiler`` with CUDA activity only; returns
    its result, the summed duration (ms) of the kernels the card ran and
    their count, read from the profiler's Chrome trace (events of category
    ``kernel``; copies and fills are not kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    path = REPO / ".chip_tmp" / "profile.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    return out, sum(float(e["dur"]) for e in kernels) / 1e3, len(kernels)


def phase_trace(tree: Path, db_dir: Path, kernel_ms: dict, card: str) -> dict:
    """``fs --scanners vuln,secret,license`` over the fs-vuln tree through
    the command line, after sixteen license files are added to the tree:
    plain under ``torch.profiler`` (the card's measured busy share: kernel
    time over the scan's wall time, beside the share derived from its
    launches times each kernel's ``timing`` ms), then with ``--trace-out``,
    ``--metrics-out``, ``--profile-out`` and ``--timeseries-out``, then
    plain without the profiler (what tracing costs: the traced scan's
    seconds over this one's). Equal ``Results``, every file parsed, the feed's three threads on the trace's
    tracks, the stall verdict over the secret, license and CVE pipelines and
    every expected span are required."""
    t_phase = time.perf_counter()
    out = tree.parent / "trace-out"
    out.mkdir(exist_ok=True)
    # the tree's licenses are package metadata: license files put the
    # classifier's device path (eight texts and up) on the traced scan too
    for name in sorted(FULL_TEXTS)[:TRACE_LICENSE_FILES]:
        (tree / "licenses" / name).mkdir(parents=True, exist_ok=True)
        (tree / "licenses" / name / "LICENSE").write_text(FULL_TEXTS[name])
    head = ["fs", "--scanners", "vuln,secret,license", "--db-repository", str(db_dir),
            "--format", "json", "--device", "cuda", "-q"]

    def scan(tag: str, *extra: str) -> tuple[int, float, dict]:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        rc = cli.main([*head, "-o", str(out / f"{tag}.json"), *extra, str(tree)])
        return rc, time.perf_counter() - t0, dict(LAUNCHES)

    (rc_p, plain_s, launches), busy_ms, n_kernels = profiled_kernel_ms(lambda: scan("plain"))
    exports = [a for name in TRACE_EXPORTS for a in (f"--{name}-out", str(out / f"{name}.json"))]
    rc_t, traced_s, _ = scan("traced", *exports)
    rc_u, untraced_s, _ = scan("untraced")
    check(rc_p == rc_t == rc_u == 0, f"trace: exit codes {rc_p} {rc_t} {rc_u}")
    results = [json.loads((out / f"{t}.json").read_text())["Results"]
               for t in ("plain", "traced", "untraced")]
    docs = {name: json.loads((out / f"{name}.json").read_text()) for name in TRACE_EXPORTS}
    metrics = docs["metrics"]
    spans = {e["name"] for e in docs["trace"]["traceEvents"] if e.get("ph") == "X"}
    stall = metrics["stall"]
    derived_ms = sum(n * kernel_ms.get(k, 0.0) for k, n in launches.items())
    result = {
        "phase": "trace", "plain_s": plain_s, "traced_s": traced_s,
        "untraced_s": untraced_s, "tracing_cost": traced_s / untraced_s - 1,
        "results_equal": results[0] == results[1] == results[2],
        "stall": [f"{p}: " + " / ".join(f"{b} {pcts[b]}%" for b in STALL_ORDER if b in pcts)
                  for p, pcts in stall.items()],
        "host_split_s": {k: round(v["total"], 4) for k, v in sorted(
            metrics["spans"].items(), key=lambda kv: -kv[1]["total"])},
        "span_threads": {k: len({e["tid"] for e in docs["trace"]["traceEvents"]
                                 if e.get("name") == k and e.get("ph") == "X"})
                         for k in TRACE_TRACKS.values()},
        "counters": metrics["counters"], "launches": launches,
        "kernels_profiled": n_kernels, "busy_ms": busy_ms,
        "busy_share_measured": busy_ms / (plain_s * 1e3),
        "derived_ms": derived_ms, "busy_share_derived": derived_ms / (plain_s * 1e3),
        "series": sorted(docs["timeseries"]["series"]), "device": metrics.get("device"),
        "seconds": time.perf_counter() - t_phase, "card": card,
    }
    log(result)
    check(result["results_equal"], "trace: Results differ between the plain and traced scans")
    missing = [t for t, name in TRACE_TRACKS.items() if name not in spans]
    check(not missing, f"trace: no traceEvents on the {missing} tracks")
    check({"secret", "license", "cve"} <= set(stall), f"trace: stall verdict {stall}")
    absent = sorted(set(TRACE_SPANS) - set(metrics["spans"]))
    check(not absent, f"trace: spans missing: {absent}")
    check(sum(launches.values()) > 0, "trace: the plain scan launched no kernel")
    check(n_kernels > 0, "trace: torch.profiler recorded no kernel on the card")
    return result


# the formats phase: each format once on the card, each against the CPU
FORMATS = ("json", "cyclonedx", "spdx-json", "spdx", "sarif", "github", "cosign-vuln", "table",
           "template")
# the fields each format derives from the scan's clock (the report's
# CreatedAt, or the clock itself for cosign-vuln): two scans differ in these
# alone, and each appears once
FORMAT_TIME_FIELDS = {
    "json": (r'"CreatedAt": "[^"]*"',),
    "cyclonedx": (r'"serialNumber": "[^"]*"', r'"timestamp": "[^"]*"'),
    "spdx-json": (r'"documentNamespace": "[^"]*"', r'"created": "[^"]*"'),
    "spdx": (r"(?m)^DocumentNamespace: .*$", r"(?m)^Created: .*$"),
    "github": (r'"scanned": "[^"]*"',),
    "cosign-vuln": (r'"CreatedAt": "[^"]*"', r'"scanStartedOn": "[^"]*"',
                    r'"scanFinishedOn": "[^"]*"'),
}
FORMATS_TEMPLATE = (
    "{{ .ArtifactName }} ({{ .ArtifactType }})\n"
    "{{ range .Results }}{{ .Target }} {{ .Class | toUpper }}: {{ len .Packages }} packages, "
    "{{ len .Vulnerabilities }} vulnerabilities, {{ len .Secrets }} secrets\n"
    "{{ range .Vulnerabilities }}  {{ .VulnerabilityID }} {{ .PkgName | escapeXML }}@"
    "{{ .InstalledVersion }} {{ .Severity | toLower }}\n{{ end }}{{ end }}"
)
# what the formats phase copies from the fs-vuln tree: one lockfile of each
# kind, the debian root, 100 node_modules packages, the trace phase's license
# files and one planted secret (``src/module_0.py``)
FORMATS_CUT = ("services/web00", "services/go00", "crates/c00", "etc/os-release",
               "var/lib/dpkg/status", "licenses", "src/module_0.py")
FORMATS_NODE_MODULES = 100
FORMATS_EDGES = 5  # planted npm packages reached through a dependency edge
FORMATS_CPU_PROCS = 5  # CPU reference scans run at once beside the card's


def mask_time(fmt: str, text: str) -> str:
    """``text`` with each clock-derived field of ``fmt`` masked; each must
    appear exactly once."""
    for pat in FORMAT_TIME_FIELDS.get(fmt, ()):
        text, n = re.subn(pat, "<time>", text)
        check(n == 1, f"formats: {fmt} has {n} fields matching {pat}, want 1")
    return text


def write_formats_tree(src: Path, dst: Path) -> list[tuple]:
    """The cut of the fs-vuln tree (``FORMATS_CUT``) and a lockfile whose
    packages each depend on a planted vulnerable npm package: no plant in
    the cut has a dependent (fs-vuln's npm lockfiles name their packages
    from the root, which is no package). Returns the (dependent, planted
    name, version) of those edges."""
    for rel in FORMATS_CUT:
        if (src / rel).is_dir():
            shutil.copytree(src / rel, dst / rel)
        else:
            (dst / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(src / rel, dst / rel)
    for k in range(FORMATS_NODE_MODULES):
        shutil.copytree(src / f"web/node_modules/nm-pkg-{k:04d}",
                        dst / f"web/node_modules/nm-pkg-{k:04d}")
    edges = [(f"dep-app-{j:02d}", name, vuln) for j, (_t, _b, name, _v, vuln, _hi) in
             enumerate(p for p in plants() if p[0] == "npm") if j < FORMATS_EDGES]
    packages = {"": {"name": "edges", "dependencies": {app: "*" for app, _n, _v in edges}}}
    for app, name, vuln in edges:
        packages[f"node_modules/{app}"] = {"version": "1.0.0", "dependencies": {name: "*"}}
        packages[f"node_modules/{name}"] = {"version": vuln}
    (dst / "services/edges").mkdir(parents=True)
    (dst / "services/edges/package-lock.json").write_text(json.dumps(
        {"name": "edges", "lockfileVersion": 3, "packages": packages}))
    # an AWS key, under an anchored rule, so that the anchored stage runs
    # with the phase's few rules (formats_rules)
    (dst / "services/edges/deploy.env").write_text(
        f"AWS_ACCESS_KEY_ID={SAMPLES['aws-access-key-id']}\n")
    return edges


def formats_rules(tree: Path, path: Path) -> None:
    """The formats phase's ``--secret-config``: the four rules of phase
    misconf and the planted secret's, so that each CPU reference stays
    short (the plain matcher over the 113 built-in rules costs it about
    40 s); the matcher's full rules are the e2e and license phases'."""
    text = (tree / "src/module_0.py").read_text(encoding="latin-1")
    planted = {rid for rid, tok in SAMPLES.items() if tok in text}
    path.write_text("enable-builtin-rules:\n" + "".join(
        f"  - {r}\n" for r in sorted(planted | set(MISCONF_RULES))))


def phase_formats(root: Path, fs_tree: Path, db_dir: Path, card: str) -> dict:
    """Every report format of the JAX CLI through ``cli.main`` on a cut of
    the fs-vuln tree: ``fs --scanners vuln,secret,license --list-all-pkgs``
    once on the card per format (``table`` with ``--dependency-tree``,
    ``template`` with an ``@file``), launch counters to 0 just before each
    scan and read just after; the same command with ``--device cpu`` (as
    ``python -m trivy_tpu_torch``, ``FORMATS_CPU_PROCS`` at once beside the
    card's scans) must give the same bytes, the clock-derived fields masked.
    ``convert`` of the card's JSON into the eight other formats must give
    the card scans' bytes; ``sbom`` of the card's CycloneDX on the card must
    report the fs scan's vulnerabilities. Printed: bytes, scan and writer
    seconds per format, the SBOM's components and the launches."""
    t_phase = time.perf_counter()
    tree, out = root / "tree", root / "out"
    edges = write_formats_tree(fs_tree, tree)
    out.mkdir(parents=True)
    tmpl = root / "report.tmpl"
    tmpl.write_text(FORMATS_TEMPLATE)
    formats_rules(tree, root / "secret.yaml")
    head = ["fs", "--scanners", "vuln,secret,license", "--db-repository", str(db_dir),
            "--list-all-pkgs", "--secret-config", str(root / "secret.yaml"), "-q"]

    def fmt_args(fmt: str) -> list[str]:
        extra = {"table": ["--dependency-tree"], "template": ["-t", f"@{tmpl}"]}
        return ["--format", fmt, *extra.get(fmt, [])]

    def cpu_scan(fmt: str) -> tuple[int, float]:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "trivy_tpu_torch", *head, *fmt_args(fmt), "--device", "cpu",
             "-o", str(out / f"cpu.{fmt}"), str(tree)],
            env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"},
            capture_output=True)
        if proc.returncode:
            log({"phase": "formats", "cpu_stderr": proc.stderr.decode()[-2000:]})
        return proc.returncode, time.perf_counter() - t0

    per_fmt: dict[str, dict] = {}
    launches: dict[str, int] = {}
    with ThreadPoolExecutor(FORMATS_CPU_PROCS) as pool:
        cpu_runs = {fmt: pool.submit(cpu_scan, fmt) for fmt in FORMATS}
        for fmt in FORMATS:
            LAUNCHES.clear()
            t0 = time.perf_counter()
            rc = cli.main([*head, *fmt_args(fmt), "--device", "cuda", "-o",
                           str(out / f"card.{fmt}"), str(tree)])
            scan_s = time.perf_counter() - t0
            lc = dict(LAUNCHES)
            check(rc == 0, f"formats: the card scan to {fmt} exited {rc}")
            for k, n in lc.items():
                launches[k] = launches.get(k, 0) + n
            per_fmt[fmt] = {"card_s": scan_s, "launches": lc,
                            "bytes": (out / f"card.{fmt}").stat().st_size}
        for fmt, fut in cpu_runs.items():
            rc, cpu_s = fut.result()
            check(rc == 0, f"formats: the CPU scan to {fmt} exited {rc}")
            per_fmt[fmt]["cpu_s"] = cpu_s
    card_text = {f: (out / f"card.{f}").read_text(encoding="utf-8") for f in FORMATS}
    for fmt in FORMATS:
        cpu = mask_time(fmt, (out / f"cpu.{fmt}").read_text(encoding="utf-8"))
        per_fmt[fmt]["equal_cpu"] = mask_time(fmt, card_text[fmt]) == cpu
    for fmt in FORMATS[1:]:
        t0 = time.perf_counter()
        rc = cli.main(["convert", *fmt_args(fmt), "-q", "-o", str(out / f"convert.{fmt}"),
                       str(out / "card.json")])
        per_fmt[fmt]["convert_s"] = time.perf_counter() - t0
        check(rc == 0, f"formats: convert to {fmt} exited {rc}")
        got = (out / f"convert.{fmt}").read_text(encoding="utf-8")
        per_fmt[fmt]["equal_convert"] = mask_time(fmt, got) == mask_time(fmt, card_text[fmt])
    # the writers alone, on the card scan's report read back
    doc = json.loads(card_text["json"])
    check(Report.from_dict(doc).to_dict() == doc, "formats: the JSON report does not read back")
    for fmt in FORMATS:
        kw = {"table": {"dependency_tree": True}, "template": {"template": f"@{tmpl}"}}
        report = Report.from_dict(doc)
        t0 = time.perf_counter()
        report_pkg.write(report, fmt, io.StringIO(), **kw.get(fmt, {}))
        per_fmt[fmt]["writer_s"] = time.perf_counter() - t0
    LAUNCHES.clear()
    t0 = time.perf_counter()
    rc = cli.main(["sbom", "--db-repository", str(db_dir), "--format", "json", "--device", "cuda",
                   "-q", "-o", str(out / "sbom.json"), str(out / "card.cyclonedx")])
    sbom_s = time.perf_counter() - t0
    sbom_launches = dict(LAUNCHES)
    check(rc == 0, f"formats: sbom of the card's CycloneDX exited {rc}")
    for k, n in sbom_launches.items():
        launches[k] = launches.get(k, 0) + n

    def vulns(text: str) -> set:
        return {(v["VulnerabilityID"], v["PkgName"], v["InstalledVersion"])
                for r in json.loads(text)["Results"] for v in r.get("Vulnerabilities", [])}

    fs_vulns = vulns(card_text["json"])
    sbom_vulns = vulns((out / "sbom.json").read_text())
    dep_tree = card_text["table"].partition("Dependency Origin Tree (Reversed)")[2]
    missing_edges = [e for e in edges if f"{e[1]}@{e[2]}, (" not in dep_tree
                     or f"{e[0]}@1.0.0 (direct)" not in dep_tree]
    components = len(json.loads(card_text["cyclonedx"])["components"])
    result = {
        "phase": "formats", "per_format": per_fmt, "sbom_components": components,
        "vulnerabilities": len(fs_vulns), "sbom_equal_fs": sbom_vulns == fs_vulns,
        "sbom_s": sbom_s, "sbom_launches": sbom_launches, "launches": launches,
        "edges_missing": missing_edges, "seconds": time.perf_counter() - t_phase, "card": card,
    }
    log(result)
    for fmt, res in per_fmt.items():
        check(res["equal_cpu"], f"formats: {fmt} differs between the card and the CPU")
        check(res.get("equal_convert", True), f"formats: convert to {fmt} differs from the scan")
        check(res["launches"].get("prefilter", 0) > 0 and res["launches"].get("verscmp") == 1,
              f"formats: the card scan to {fmt} launched {res['launches']}")
    check(result["sbom_equal_fs"], "formats: sbom of the CycloneDX differs from the fs scan")
    check(sbom_launches.get("verscmp", 0) == 1, f"formats: sbom launched {sbom_launches}")
    check(not missing_edges, f"formats: dependency tree lacks {missing_edges}")
    check(components > 1000 and len(fs_vulns) > 10,
          f"formats: {components} components, {len(fs_vulns)} vulnerabilities")
    check(all(launches.get(k, 0) > 0 for k in (*IMAGE_KERNELS, "verscmp")),
          f"formats: kernels not launched: {launches}")
    return result


# client/server mode (phase server): the lockfile subsets the concurrent
# clients of run (c) scan, and the raw submits of run (d)'s burst
SERVER_CLIENTS = 4
SERVER_BURST = 8


class RecordingCache(MemoryCache):
    """The in-process server's cache, keeping the IDs of the blobs clients
    put, in order."""

    def __init__(self):
        super().__init__()
        self.put_ids: list[str] = []

    def put_blob(self, blob_id: str, info: dict) -> None:
        self.put_ids.append(blob_id)
        super().put_blob(blob_id, info)


# -- phase misconf: the misconfiguration scanner in the feed's walk ------------

# multi-stage Dockerfiles with continuations, each service its own variant
MISCONF_DOCKERFILE = """# build stage
FROM golang:1.22 AS build
WORKDIR /src
RUN apt-get update && \\
    apt-get install -y git curl && \\
    go build -o /bin/app{i} ./cmd
FROM alpine:latest
MAINTAINER ops@example.com
RUN apk add curl
ADD bin/ /opt/app{i}
COPY --from=build /bin/app{i} /bin/app{i}
EXPOSE 22 8080
USER root
CMD ["/bin/app{i}"]
"""
# Kubernetes manifests: several kinds in one file, and one hardened pod
MISCONF_MANIFEST = """apiVersion: apps/v1
kind: Deployment
metadata:
  name: web{i}
spec:
  template:
    spec:
      hostPID: true
      containers:
      - name: app
        image: nginx:latest
---
apiVersion: batch/v1
kind: CronJob
metadata:
  name: job{i}
spec:
  jobTemplate:
    spec:
      template:
        spec:
          containers:
          - name: job
            image: busybox:1.36
            securityContext:
              privileged: true
---
apiVersion: v1
kind: Service
metadata:
  name: svc{i}
spec:
  ports: [{{port: 80}}]
"""
MISCONF_HARDENED = """apiVersion: v1
kind: Pod
metadata:
  name: good
  annotations:
    container.apparmor.security.beta.kubernetes.io/app: runtime/default
spec:
  automountServiceAccountToken: false
  containers:
  - name: app
    image: nginx:1.25.3
    securityContext:
      allowPrivilegeEscalation: false
      runAsNonRoot: true
      runAsUser: 10001
      runAsGroup: 10001
      readOnlyRootFilesystem: true
      seccompProfile:
        type: RuntimeDefault
      capabilities:
        drop: [ALL]
    resources:
      limits: {cpu: "1", memory: 1Gi}
      requests: {cpu: 500m, memory: 512Mi}
"""
# the phase's secret rules (``--secret-config``): four built-ins, so that
# its CPU scans, each a reference for a card scan, stay short
MISCONF_RULES = ("aws-access-key-id", "github-pat", "gitlab-pat", "slack-access-token")
# the failures every Dockerfile and every manifest above must report
MISCONF_IDS = {"DS001", "DS002", "DS004", "DS005", "DS022", "DS026", "DS029",
               "KSV001", "KSV010", "KSV011", "KSV013", "KSV017", "KSV018"}
# leg (b)'s custom checks: a Python check over YAML/JSON and a Rego check
# over manifests (the check API of trivy_tpu_torch/misconf/custom.py)
MISCONF_PY_CHECK = """
@check(id="USR-PY-001", severity="HIGH", types=("yaml", "json"), title="debug enabled")
def debug_enabled(docs):
    for doc in docs:
        if isinstance(doc, dict) and doc.get("debug") is True:
            yield Failure("debug is enabled", start_line=doc.line("debug"))
"""
MISCONF_REGO_CHECK = """
# METADATA
# title: "Deployment not allowed"
# custom:
#   id: USR-K8S-100
#   severity: CRITICAL
#   input:
#     selector:
#     - type: kubernetes
package user.kubernetes.USR100

deny[msg] {
    input.kind == "Deployment"
    msg := sprintf("deployment %s is forbidden", [input.metadata.name])
}
"""
# leg (c): a credential planted in a stack and in a chart's values, under
# two of the phase's rules
IAC_SECRETS = {"aws": "aws-access-key-id", "github": "github-pat"}
# leg (f): a credential planted in each place of the monorepo (provider
# blocks and .tfvars), under the phase's four rules, and the ids it must fail
TF_SECRETS = {"aws": "aws-access-key-id", "gitlab": "gitlab-pat", "github": "github-pat",
              "slack": "slack-access-token"}
TF_IDS = {"AVD-AWS-0092", "AVD-AWS-0107", "AVD-GCP-0002", "AVD-AZU-0008", "AVD-GIT-0001"}
# an image history that rebuilds as a Dockerfile failing DS005 (ADD) and
# DS025 (apk add without --no-cache)
MISCONF_HISTORY = [
    {"created_by": "/bin/sh -c #(nop) ADD file:0a1b2c in / "},
    {"created_by": "/bin/sh -c #(nop)  CMD [\"sh\"]", "empty_layer": True},
    {"created_by": "/bin/sh -c apk add curl"},
    {"created_by": "/bin/sh -c #(nop)  USER root", "empty_layer": True},
]


def write_misconf_tree(root: Path, seed: int, base: bytes) -> int:
    """Leg (a)'s tree, about 2 MiB: eight Dockerfiles, eight manifests and
    the hardened pod, a plain YAML and a JSON file, planted secrets, twelve
    license files and source text. Returns the bytes written."""
    rng = random.Random(seed + 23)
    keys = sorted(FULL_TEXTS)
    written = 0

    def put(rel: str, data: bytes) -> None:
        nonlocal written
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        written += len(data)

    for i in range(8):
        put(f"svc{i}/Dockerfile", MISCONF_DOCKERFILE.format(i=i).encode())
        put(f"deploy/app-{i}.yaml", MISCONF_MANIFEST.format(i=i).encode())
        rule = MISCONF_RULES[i % len(MISCONF_RULES)]
        put(f"app/settings_{i}.py", base[:2048] + SAMPLES[rule].encode() + b"\n")
    put("deploy/hardened.yaml", MISCONF_HARDENED.encode())
    put("config/values.yaml", b"replicas: 3\ndebug: true\nimage:\n  tag: latest\n")
    put("config/settings.json", b'{\n  "debug": true,\n  "port": 8080\n}\n')
    for i in range(12):
        put(f"lic/p{i}/LICENSE", license_text(rng, base, keys[i % len(keys)], i % 3, 8192))
    for i in range(6):
        off = rng.randrange(0, len(base) - (256 << 10))
        put(f"src/module_{i}.py", base[off : off + (256 << 10)])
    return written


def misconf_terraform(tree: Path, out: Path, rules: Path, seed: int) -> dict:
    """Phase misconf's leg (f): ``fs --scanners misconfig,secret`` of the
    seeded Terraform monorepo on the card and on the CPU."""
    t_leg = time.perf_counter()
    planted = {place: SAMPLES[rule] for place, rule in TF_SECRETS.items()}
    counts = TFTREE["write_tf_monorepo"](tree, seed, secrets=planted)
    metrics = out / "f-cuda.metrics.json"
    head = ("--secret-config", str(rules))
    LAUNCHES.clear()
    on_card, stats = run_cli(tree, out, "f-cuda", "cuda", *head, "--metrics-out", str(metrics),
                             scanners="misconfig,secret")
    launches = dict(LAUNCHES)
    on_cpu, cpu_stats = run_cli(tree, out, "f-cpu", "cpu", *head, scanners="misconfig,secret")
    spans = json.loads(metrics.read_text())["spans"]
    fails = config_failures(on_card)
    reported = set().union(*fails.values()) if fails else set()
    secrets = sorted((r["Target"], s["RuleID"]) for r in on_card["Results"]
                     for s in r.get("Secrets", []))
    leg = {"tf_files": counts["tf_files"], "tf_bytes": counts["tf_bytes"],
           "tree_bytes": counts["bytes"], "seconds": stats["seconds"],
           "cpu_seconds": cpu_stats["seconds"],
           "terraform_span_s": spans.get("misconf.terraform", {}).get("total"),
           "misconf_span_s": spans.get("misconf.scan_files", {}).get("total"),
           "launches": launches, "config_results": len(fails),
           "failures": sum(1 for r in on_card["Results"] for m in r.get("Misconfigurations", [])
                           if m["Status"] == "FAIL"),
           "types": sorted({r["Type"] for r in on_card["Results"] if r["Class"] == "config"}),
           "secrets": secrets,
           "equal_to_cpu": (on_card["Results"] == on_cpu["Results"]
                            and on_card["Metadata"] == on_cpu["Metadata"])}
    shutil.rmtree(tree, ignore_errors=True)
    leg["leg_seconds"] = time.perf_counter() - t_leg
    log({"phase": "misconf-f", **leg})
    check(leg["equal_to_cpu"], "misconf (f): Results or Metadata differ from --device cpu")
    check(TF_IDS <= reported and any(i.startswith("AVD-DIG-") for i in reported),
          f"misconf (f): missing {sorted(TF_IDS - reported)} or every AVD-DIG id")
    check(leg["types"] == ["azure-arm", "terraform", "terraformplan-json"],
          f"misconf (f): config results of the types {leg['types']}")
    check(sorted(rule for _, rule in secrets) == sorted(TF_SECRETS.values()),
          f"misconf (f): secrets {secrets}")
    check(all(launches.get(k, 0) > 0 for k in ("prefilter", "anchored", "decompress")),
          f"misconf (f): a feed kernel was not launched: {launches}")
    check(leg["terraform_span_s"] is not None, "misconf (f): no misconf.terraform span")
    return leg


def misconf_iac(tree: Path, out: Path, rules: Path, seed: int, a_tree: Path) -> dict:
    """Phase misconf's leg (c): ``fs --scanners misconfig,secret`` of a
    seeded tree of CloudFormation stacks in YAML and JSON (intrinsics),
    Helm charts (``_helpers.tpl``, ``values.yaml``, templates), a
    Dockerfile beside them and two credentials, on the card (counters to 0
    just before, read just after) and on the CPU; then ``--compliance
    docker-cis-1.6.0 --format json`` of leg (a)'s tree, card against CPU."""
    t_leg = time.perf_counter()
    planted = {place: SAMPLES[rule] for place, rule in IAC_SECRETS.items()}
    IACTREE["write_iac_tree"](tree, seed, stacks=3, charts=3, secrets=planted)
    metrics = out / "c-cuda.metrics.json"
    head = ("--secret-config", str(rules))
    LAUNCHES.clear()
    on_card, stats = run_cli(tree, out, "c-cuda", "cuda", *head, "--metrics-out", str(metrics),
                             scanners="misconfig,secret")
    launches = dict(LAUNCHES)
    on_cpu, cpu_stats = run_cli(tree, out, "c-cpu", "cpu", *head, scanners="misconfig,secret")
    spans = json.loads(metrics.read_text())["spans"]
    fails = {(r["Type"], m["ID"]) for r in on_card["Results"]
             for m in r.get("Misconfigurations", []) if m["Status"] == "FAIL"}
    secrets = sorted((r["Target"], s["RuleID"]) for r in on_card["Results"]
                     for s in r.get("Secrets", []))
    compliance = {}
    for device in ("cuda", "cpu"):
        path = out / f"c-compliance-{device}.json"
        rc = cli.main(["fs", "--scanners", "misconfig,secret",
                       "--secret-config", str(rules), "--compliance", "docker-cis-1.6.0",
                       "--format", "json", "-q", "-o", str(path), "--device", device,
                       str(a_tree)])
        check(rc == 0, f"misconf (c): --compliance on {device} exited {rc}")
        compliance[device] = json.loads(path.read_text())
    leg = {"seconds": stats["seconds"], "cpu_seconds": cpu_stats["seconds"],
           "helm_span_s": spans.get("misconf.helm", {}).get("total"),
           "misconf_span_s": spans.get("misconf.scan_files", {}).get("total"),
           "launches": {k: launches.get(k, 0) for k in ("prefilter", "anchored", "decompress")},
           "types": sorted({r["Type"] for r in on_card["Results"] if r["Class"] == "config"}),
           "failures": len(fails), "secrets": secrets,
           "equal_to_cpu": (on_card["Results"] == on_cpu["Results"]
                            and on_card["Metadata"] == on_cpu["Metadata"]),
           "compliance": compliance["cuda"]["SummaryControls"],
           "compliance_equal_to_cpu": compliance["cuda"] == compliance["cpu"]}
    shutil.rmtree(tree, ignore_errors=True)
    leg["leg_seconds"] = time.perf_counter() - t_leg
    log({"phase": "misconf-c", **leg})
    check(leg["equal_to_cpu"], "misconf (c): Results or Metadata differ from --device cpu")
    want = ({("cloudformation", i) for i in IACTREE["CFN_IDS"]}
            | {("helm", i) for i in IACTREE["HELM_IDS"]})
    check(want <= fails, f"misconf (c): missing {sorted(want - fails)}")
    check({"cloudformation", "helm", "dockerfile"} <= set(leg["types"]),
          f"misconf (c): config results of the types {leg['types']}")
    check(sorted(rule for _, rule in secrets) == sorted(IAC_SECRETS.values()),
          f"misconf (c): secrets {secrets}")
    check(all(leg["launches"][k] > 0 for k in leg["launches"]),
          f"misconf (c): a feed kernel was not launched: {launches}")
    check(leg["helm_span_s"] is not None, "misconf (c): no misconf.helm span")
    check(leg["compliance_equal_to_cpu"] and compliance["cuda"]["ID"] == "docker-cis-1.6.0"
          and compliance["cuda"]["SummaryControls"].get("FAIL", 0) > 0,
          f"misconf (c): --compliance gave {leg['compliance']}, equal to the CPU: "
          f"{leg['compliance_equal_to_cpu']}")
    return leg


def config_failures(report: dict) -> dict[str, set]:
    """{target: failed check ids} of a report's config results."""
    return {r["Target"]: {m["ID"] for m in r.get("Misconfigurations", [])
                          if m["Status"] == "FAIL"}
            for r in report["Results"] if r["Class"] == "config"}


def phase_misconf(root: Path, seed: int, base: bytes, card: str) -> dict:
    """``--scanners misconfig`` in the feed's walk, through ``cli.main``:
    (a) ``fs --scanners misconfig,secret,license --license-full`` on the
    card (launch counters to 0 just before, read just after) and on the CPU:
    equal ``Results`` and ``Metadata``, the expected DS/KSV failures, every
    feed and license kernel launched; (b) the same with a Python and a Rego
    ``--config-check`` and four ``--misconfig-scanners``; (c) a seeded tree
    of CloudFormation stacks (YAML and JSON), Helm charts, a Dockerfile and
    two credentials with ``misconfig,secret`` on the card and on the CPU:
    equal ``Results`` and ``Metadata``, the stacks' and the charts' ids, the
    ``misconf.helm`` span and the feed's launches on a line of their own;
    then ``--compliance docker-cis-1.6.0`` of (a)'s tree, card against CPU;
    (d)
    ``image --scanners misconfig,secret`` of a small archive, its history's
    Dockerfile checks under the JAX target, card against CPU; (e) ``-d
    --log-format json``, ``version --format json``, ``--backend cpu`` and
    ``--backend pallas --device cpu`` on the CPU, ``--backend pallas`` on
    the card; (f) ``fs --scanners misconfig,secret`` of a Terraform
    monorepo (``tests/tftree.py``: 48 modules called by 12 environment
    roots, 360 ``.tf`` files, about 2 MiB of HCL, every provider, a plan
    of just under 1 MiB, two ARM templates, four planted credentials) on
    the card (counters to 0 just before, read just after) and on the CPU:
    equal ``Results`` and ``Metadata``, the expected ids, the four secrets,
    the feed's kernels launched; its seconds, launches and the
    ``misconf.terraform`` span's seconds on a line of its own. Each leg
    prints its ``t``."""
    from trivy_tpu_torch import VERSION
    from trivy_tpu_torch.misconf import custom
    from trivy_tpu_torch.misconf.checks import unregister

    t_phase = time.perf_counter()
    tree, out = root / "tree", root / "out"
    written = write_misconf_tree(tree, seed, base)
    out.mkdir(parents=True)
    rules = root / "secret.yaml"
    rules.write_text("enable-builtin-rules:\n" + "".join(f"  - {r}\n" for r in MISCONF_RULES))
    result: dict = {"phase": "misconf", "tree_bytes": written}
    head = ("--license-full", "--secret-config", str(rules))
    scanners = "misconfig,secret,license"

    # (a) the card against the CPU
    LAUNCHES.clear()
    on_card, stats = run_cli(tree, out, "a-cuda", "cuda", *head, scanners=scanners)
    launches = dict(LAUNCHES)
    on_cpu, _ = run_cli(tree, out, "a-cpu", "cpu", *head, scanners=scanners)
    fails = config_failures(on_card)
    reported = set().union(*fails.values()) if fails else set()
    leg_a = {"seconds": stats["seconds"], "launches": launches,
             "config_results": len(fails), "secret_results": sum(
                 1 for r in on_card["Results"] if r["Class"] == "secret"),
             "license_results": sum(1 for r in on_card["Results"] if r.get("Licenses")),
             "equal_to_cpu": (on_card["Results"] == on_cpu["Results"]
                              and on_card["Metadata"] == on_cpu["Metadata"])}
    log({"phase": "misconf-a", **leg_a})
    check(leg_a["equal_to_cpu"], "misconf (a): Results or Metadata differ from --device cpu")
    check(MISCONF_IDS <= reported, f"misconf (a): missing {sorted(MISCONF_IDS - reported)}")
    check(not fails.get("deploy/hardened.yaml"), "misconf (a): the hardened pod failed "
          f"{sorted(fails.get('deploy/hardened.yaml', ()))}")
    check(all(launches.get(k, 0) > 0 for k in IMAGE_KERNELS),
          f"misconf (a): a kernel was not launched on the main path: {launches}")
    check(leg_a["secret_results"] == 8 and leg_a["license_results"] > 0,
          f"misconf (a): {leg_a['secret_results']} secret results, "
          f"{leg_a['license_results']} license results")
    result["a"] = leg_a

    # (c) CloudFormation and Helm beside the feed, and --compliance
    result["c"] = misconf_iac(root / "iac", out, rules, seed, tree)

    # (d) an image's history as a Dockerfile, beside its layers' files
    layers = [layer_tar(tree / "svc0", extra={"deploy/app.yaml": MISCONF_MANIFEST.format(
                  i=0).encode()}),
              layer_tar(tree / "app")]
    IMAGES["docker_save_tar"](str(root / "image.tar"), layers, history=MISCONF_HISTORY,
                              repo_tag="chip-smoke/misconf:latest")
    image = {}
    for device in ("cuda", "cpu"):
        path = out / f"d-{device}.json"
        rc = cli.main(["image", "--scanners", "misconfig,secret", "--format", "json", "-q",
                       "-o", str(path), "--device", device, "--secret-config", str(rules),
                       "--cache-dir",
                       str(root / f"cache-{device}"), str(root / "image.tar")])
        check(rc == 0, f"misconf (d): image scan on {device} exited {rc}")
        image[device] = json.loads(path.read_text())
    history = config_failures(image["cuda"]).get("Dockerfile (image history)", set())
    result["d"] = {"results": len(image["cuda"]["Results"]), "history_failures": sorted(history),
                   "equal_to_cpu": (image["cuda"]["Results"] == image["cpu"]["Results"]
                                    and image["cuda"]["Metadata"] == image["cpu"]["Metadata"])}
    log({"phase": "misconf-d", **result["d"]})
    check(result["d"]["equal_to_cpu"], "misconf (d): image Results differ from --device cpu")
    check({"DS005", "DS025"} <= history, f"misconf (d): history failures {sorted(history)}")

    # (e) the global flags and the small commands
    err = io.StringIO()
    # the port's log lines alone: a library's warning would print as text
    with contextlib.redirect_stderr(err), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = cli.main(["fs", "--scanners", "misconfig", "-d", "--log-format", "json",
                       "--format", "json", "-o", str(out / "e.json"), "--device", "cuda",
                       str(tree)])
    lines = [ln for ln in err.getvalue().splitlines() if ln.strip()]
    docs = []
    for ln in lines:
        try:
            docs.append(json.loads(ln))
        except ValueError:
            docs.append(None)
    json_ok = rc == 0 and bool(docs) and all(isinstance(d, dict) and d.get("trace_id")
                                             for d in docs)
    ver = io.StringIO()
    with contextlib.redirect_stdout(ver):
        vrc = cli.main(["version", "--format", "json"])
    backends = {}
    for tag, extra in (("cpu", ["--backend", "cpu"]),
                       ("pallas-device-cpu", ["--backend", "pallas", "--device", "cpu"]),
                       ("pallas", ["--backend", "pallas"])):
        LAUNCHES.clear()
        rc_b = cli.main(["fs", "--scanners", "secret", "--format", "json", "-q", "-o",
                         str(out / f"e-{tag}.json"), "--secret-config", str(rules), *extra,
                         str(tree / "app")])
        backends[tag] = {"rc": rc_b, "launches": sum(LAUNCHES.values()),
                         "results": json.loads((out / f"e-{tag}.json").read_text())["Results"]}
    result["e"] = {"log_lines": len(docs), "log_json_with_trace_id": json_ok,
                   "version": json.loads(ver.getvalue() or "{}"), "version_rc": vrc,
                   "backend_launches": {k: v["launches"] for k, v in backends.items()}}
    log({"phase": "misconf-e", **result["e"]})
    check(json_ok, f"misconf (e): -d --log-format json gave rc {rc} and lines {lines[:3]}")
    check(vrc == 0 and result["e"]["version"] == {"Version": VERSION},
          f"misconf (e): version printed {ver.getvalue()!r}")
    check(all(b["rc"] == 0 for b in backends.values())
          and backends["cpu"]["launches"] == backends["pallas-device-cpu"]["launches"] == 0
          and backends["pallas"]["launches"] > 0
          and backends["cpu"]["results"] == backends["pallas"]["results"]
          == backends["pallas-device-cpu"]["results"],
          f"misconf (e): --backend runs {result['e']['backend_launches']}")

    # (f) a Terraform monorepo at the size of a real infrastructure
    # repository, beside the feed
    result["f"] = misconf_terraform(root / "terraform", out, rules, seed)

    # (b) custom checks, last: they stay registered in the process until
    # the phase takes them out
    checks = root / "checks"
    checks.mkdir()
    (checks / "debug.py").write_text(MISCONF_PY_CHECK)
    (checks / "deploy.rego").write_text(MISCONF_REGO_CHECK)
    extra = ("--config-check", str(checks), "--misconfig-scanners",
             "dockerfile,kubernetes,yaml,json")
    try:
        LAUNCHES.clear()
        b_card, b_stats = run_cli(tree, out, "b-cuda", "cuda", *head, *extra, scanners=scanners)
        b_launches = dict(LAUNCHES)
        b_cpu, _ = run_cli(tree, out, "b-cpu", "cpu", *head, *extra, scanners=scanners)
    finally:
        for cid in list(custom._custom_ids):
            unregister(cid)
        custom._custom_ids.clear()
        custom._loaded_files.clear()
    b_fails = config_failures(b_card)
    custom_ids = set().union(*b_fails.values()) & {"USR-PY-001", "USR-K8S-100"}
    result["b"] = {"seconds": b_stats["seconds"], "launches": b_launches,
                   "custom_ids": sorted(custom_ids),
                   "equal_to_cpu": (b_card["Results"] == b_cpu["Results"]
                                    and b_card["Metadata"] == b_cpu["Metadata"])}
    log({"phase": "misconf-b", **result["b"]})
    check(result["b"]["equal_to_cpu"], "misconf (b): Results differ from --device cpu")
    check(custom_ids == {"USR-PY-001", "USR-K8S-100"},
          f"misconf (b): custom checks reported {sorted(custom_ids)}")
    result["seconds"] = time.perf_counter() - t_phase
    result["launches"] = launches
    log({"phase": "misconf-done", "seconds": result["seconds"], "card": card})
    return result


def server_subsets(fs_tree: Path, root: Path) -> list[Path]:
    """Client t's lockfile set: the t-th npm, golang and cargo lockfiles of
    the fs-vuln tree (a few thousand components, plants among them)."""
    out = []
    for t in range(SERVER_CLIENTS):
        for rel in (f"services/web{t:02d}/package-lock.json", f"services/go{t:02d}/go.mod",
                    f"crates/c{t:02d}/Cargo.lock"):
            (root / f"subset{t}" / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(fs_tree / rel, root / f"subset{t}" / rel)
        out.append(root / f"subset{t}")
    return out


def post_json(url: str, doc: dict) -> tuple[int, dict, dict]:
    """One raw POST, no retry: (status, body, headers)."""
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read() or b"{}"), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextmanager
def launches_by_context():
    """Count each kernel launch, while the block runs, also under the name
    of the trace context that launched it (``obs.current().name``): a
    server's shard scan is ``server-scan:<shard>``, the coordinator's local
    fallback ``fleet-local:<shard>``, the command's own scan the command's
    name. ``LAUNCHES`` still counts every launch, as each wrapper counts it;
    the per-context counts ride on each module's ``count_launch``."""
    from collections import Counter, defaultdict

    from trivy_tpu_torch import obs
    from trivy_tpu_torch.ops import (
        bytes_gate_cuda, bytes_score_cuda, decompress_cuda, gram_gate_cuda, match_cuda,
    )

    mods = (match_cuda, gram_gate_cuda, bytes_gate_cuda, bytes_score_cuda, decompress_cuda,
            verscmp_cuda)
    saved = {m: m.count_launch for m in mods}
    by: dict = defaultdict(Counter)
    lock = threading.Lock()

    def counting(orig):
        def count_launch(name, rows=None, width=None):
            orig(name, rows, width)
            with lock:
                by[obs.current().name][name] += 1
        return count_launch

    for m in mods:
        m.count_launch = counting(saved[m])
    try:
        yield by
    finally:
        for m in mods:
            m.count_launch = saved[m]


def by_role(by: dict) -> dict:
    """Per-context launch counts summed into the replicas' shard scans, the
    coordinator's local fallback and the coordinator's own scan (the fold)."""
    out = {"replicas": {}, "fallback": {}, "fold": {}}
    for ctx, counts in by.items():
        role = ("replicas" if ctx.startswith("server-scan:") else
                "fallback" if ctx.startswith("fleet-local:") else "fold")
        for k, v in counts.items():
            out[role][k] = out[role].get(k, 0) + v
    return out


def fleet_subtree(fs_tree: Path, sub: Path) -> None:
    """A few MiB of the trace tree, hard-linked: the seeded text with its
    secrets (``src/``), the trace phase's license files and one npm
    lockfile (the fold's ``verscmp``)."""
    for rel in ("src", "licenses"):
        shutil.copytree(fs_tree / rel, sub / rel, copy_function=os.link)
    (sub / "services" / "web00").mkdir(parents=True)
    os.link(fs_tree / "services/web00/package-lock.json",
            sub / "services/web00/package-lock.json")


def fleet_image(sub: Path, path: Path) -> int:
    """A docker-save archive of three layers from the subtree: the lockfile
    and an OS release; two text files; the license files with a whiteout
    of one text file. Returns its bytes."""
    tar = IMAGES["tar_bytes"]
    src = sorted((sub / "src").iterdir())
    layers = [
        tar({"etc/os-release": b'ID=debian\nVERSION_ID="12"\n',
             "services/web00/package-lock.json":
                 (sub / "services/web00/package-lock.json").read_bytes()}),
        tar({f"src/{p.name}": p.read_bytes() for p in src[:2]}),
        tar({f"src/.wh.{src[1].name}": b"",
             **{str(p.relative_to(sub)): p.read_bytes()
                for p in sorted((sub / "licenses").rglob("LICENSE"))}}),
    ]
    IMAGES["docker_save_tar"](str(path), layers)
    return path.stat().st_size


def fleet_leg(url: str, root: Path, fs_tree: Path, db_dir: Path, device: str, local: dict,
              local_s: float) -> dict:
    """Phase server's leg (g), the fleet through the port's coordinator:
    ``cli.main``'s ``--fleet`` over the phase's server and a second
    in-process port server on the card without admission (so the
    coordinator sends it synchronous ``scan_shard`` calls after a 404 on
    submit) and a memory merge cache.
    Kernel launches are counted per trace context (``launches_by_context``):
    the replicas' shard scans, the coordinator's local fallback and the
    coordinator's fold. (g1) ``fs`` of the tree with ``vuln,secret,license
    --license-full`` in four shards (each then holds the eight license
    texts the classifier's device path takes), with the telemetry plane at
    its default interval and ``--metrics-out`` and ``--timeseries-out``:
    the local scan's ``Results``, every feed and license kernel launched by
    the replicas and no ``verscmp``, one ``verscmp`` by the fold and nothing
    else; the ``fleet`` block names both replicas, each scraped at least
    once with a headroom in [0, 1], and a replica's summary holds
    ``device_busy_ratio`` and ``queue_depth``; afterwards no
    ``trivy_tpu_fleet_*`` row and no ``fleet-telemetry`` thread is left.
    The other sub-legs scan with ``secret,license --license-full`` and no
    DB (no DB load per command). (g2) a few MiB of the tree
    (``fleet_subtree``) over the live server and a port nobody listens on,
    the plane at 0.2 s: the subtree's local ``Results``, no ``Degraded``,
    the dead replica's breaker open, no shard on it, and its block with at
    least two failed scrapes and ``breaker_open``. g3 and g4 keep
    ``--fleet-telemetry-interval 0``, the gated-off path. (g3) the subtree
    over two dead ports:
    the local fallback on the card launches the feed and license kernels
    in the coordinator, the report is ``Degraded`` with the local
    ``Results``; with ``--no-host-fallback`` the command exits 1. (g4)
    ``image --fleet`` of a three-layer archive of the subtree
    (``fleet_image``) over both servers: the local image scan's ``Results``,
    ``ImageID`` and ``DiffIDs``. (g5) ``fs --scanners misconfig,secret`` of
    a tree like phase misconf's leg (c) (CloudFormation, Helm charts, a
    Dockerfile, two credentials) in two shards over both servers: the local
    scan's ``Results``, the feed's kernels launched by the replicas'
    shards."""
    from trivy_tpu_torch.rpc.server import start_server

    out = root / "fleet"
    out.mkdir()
    httpd2, port2 = start_server(cache=MemoryCache(), device=device)
    hosts = [url.split("://", 1)[1], f"127.0.0.1:{port2}"]
    head = ["--license-full", "--device", device, "--format", "json", "-q", "--cache-backend",
            "memory"]
    off = ("--fleet-telemetry-interval", "0")
    vuln = ("--scanners", "vuln,secret,license", "--db-repository", str(db_dir))
    no_db = ("--scanners", "secret,license")

    def run(tag: str, command: str, target: Path, *extra: str) -> dict:
        with launches_by_context() as by:
            t0 = time.perf_counter()
            rc = cli.main([command, *head, "-o", str(out / f"{tag}.json"), "--stats-out",
                           str(out / f"{tag}.stats.json"), *extra, str(target)])
            seconds = time.perf_counter() - t0
        doc = out / f"{tag}.json"
        stats = out / f"{tag}.stats.json"
        return {"rc": rc, "seconds": seconds, "launches": by_role(by),
                "doc": json.loads(doc.read_text()) if doc.exists() else {},
                "stats": json.loads(stats.read_text()) if stats.exists() else {}}

    def plane(tag: str) -> dict:
        """The ``fleet`` blocks of a sub-leg's ``--metrics-out`` and (when
        written) ``--timeseries-out``."""
        ts = out / f"{tag}.ts.json"
        return {"metrics": json.loads((out / f"{tag}.metrics.json").read_text()).get("fleet"),
                "timeseries": json.loads(ts.read_text()).get("fleet") if ts.exists() else None}

    def fleet_mbs(ts_fleet: dict) -> float:
        """The poller's fleet MB/s at its final tick: the healthy replicas'
        last link MB/s, summed (``ReplicaPoller.status``)."""
        return round(sum(rep["series"].get("link_mbs", {}).get("points", [[0, 0.0]])[-1][1]
                         for rep in ts_fleet["replicas"].values()
                         if rep["reachable"] and not rep["breaker_open"]), 1)

    def summary(r: dict) -> dict:
        st = r["stats"]
        return {"rc": r["rc"], "seconds": r["seconds"], "launches": r["launches"],
                "plan_s": st.get("fleet.plan.seconds"), "fanout_s": st.get("fleet.fanout.seconds"),
                "fold_s": st.get("detect.seconds"),
                "stats": {k[len("fleet."):]: v for k, v in st.items()
                          if k.startswith("fleet.") and not k.endswith("seconds")}}

    sub = root / "fleet-sub"
    fleet_subtree(fs_tree, sub)
    image = out / "image.tar"
    image_bytes = fleet_image(sub, image)
    dead = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    try:
        g1 = run("g1", "fs", fs_tree, *vuln, "--fleet", ",".join(hosts),
                 "--fleet-shards-per-replica", "2", "--metrics-out", str(out / "g1.metrics.json"),
                 "--timeseries-out", str(out / "g1.ts.json"))
        g1_rows = [line for line in obs_metrics.REGISTRY.render().splitlines()
                   if line.startswith("trivy_tpu_fleet_")]
        g1_threads = [t.name for t in threading.enumerate()
                      if t.name.startswith("fleet-telemetry")]
        sub_local = run("sub-local", "fs", sub, *no_db)
        g2 = run("g2", "fs", sub, *no_db, "--fleet", f"{hosts[0]},{dead[0]}",
                 "--fleet-telemetry-interval", "0.2", "--metrics-out",
                 str(out / "g2.metrics.json"))
        g2_breaker = breaker_open(f"fleet:{dead[0]}")
        UNFAULTED["off"] = True  # g3 degrades on purpose: every replica is dead
        try:
            g3 = run("g3", "fs", sub, *no_db, "--fleet", ",".join(dead),
                     "--fleet-shards-per-replica", "2", *off)
            g3_loud = run("g3-loud", "fs", sub, *no_db, "--fleet", ",".join(dead),
                          "--fleet-shards-per-replica", "2", "--no-host-fallback", *off)
        finally:
            UNFAULTED["off"] = False
        image_local = run("image-local", "image", image, *no_db)
        g4 = run("g4", "image", image, *no_db, "--fleet", ",".join(hosts), *off)
        iac = root / "fleet-iac"
        IACTREE["write_iac_tree"](iac, 5, stacks=3, charts=3,
                                  secrets={k: SAMPLES[v] for k, v in IAC_SECRETS.items()})
        misconf = ("--scanners", "misconfig,secret")
        iac_local = run("iac-local", "fs", iac, *misconf)
        g5 = run("g5", "fs", iac, *misconf, "--fleet", ",".join(hosts),
                 "--fleet-shards-per-replica", "1", *off)
    finally:
        httpd2.shutdown()
    g1_plane, g2_plane = plane("g1"), plane("g2")
    g1_reps = (g1_plane["metrics"] or {}).get("replicas", {})
    g2_dead = (g2_plane["metrics"] or {}).get("replicas", {}).get(dead[0], {})

    def meta(doc: dict) -> tuple:
        return doc.get("Metadata", {}).get("ImageID"), doc.get("Metadata", {}).get("DiffIDs")

    result = {
        "hosts": hosts, "dead": dead, "local_s": local_s, "subtree_files": sum(
            1 for p in sub.rglob("*") if p.is_file()), "image_bytes": image_bytes,
        "g1": summary(g1), "g2": summary(g2), "g3": summary(g3), "g4": summary(g4),
        "g5": summary(g5), "iac_local_s": iac_local["seconds"],
        "g5_equal_local": g5["doc"].get("Results") == iac_local["doc"].get("Results"),
        "g5_types": sorted({r["Type"] for r in g5["doc"].get("Results", [])
                            if r["Class"] == "config"}),
        "sub_local_s": sub_local["seconds"], "image_local_s": image_local["seconds"],
        "g1_equal_local": g1["doc"].get("Results") == local["Results"],
        "g2_equal_local": g2["doc"].get("Results") == sub_local["doc"]["Results"],
        "g2_breaker_open": g2_breaker,
        "g3_equal_local": g3["doc"].get("Results") == sub_local["doc"]["Results"],
        "g3_degraded": g3["doc"].get("Degraded"), "g3_loud_rc": g3_loud["rc"],
        "g4_equal_local": (g4["doc"].get("Results") == image_local["doc"]["Results"]
                           and meta(g4["doc"]) == meta(image_local["doc"])),
        "g1_interval_s": (g1_plane["metrics"] or {}).get("interval_s"),
        "g1_headroom": {h: rep.get("headroom") for h, rep in g1_reps.items()},
        "g1_scrapes": {h: rep.get("scrapes") for h, rep in g1_reps.items()},
        "g1_fleet_mbs": fleet_mbs(g1_plane["timeseries"]) if g1_plane["timeseries"] else None,
        "g1_busy_ratio_max": {h: rep.get("summary", {}).get("device_busy_ratio", {}).get("max")
                              for h, rep in g1_reps.items()},
        "g1_controller": {k: v for k, v in ((g1_plane["timeseries"] or {}).get("controller")
                                            or {}).items() if k != "decision_log"},
        "g1_rows_left": g1_rows, "g1_threads_left": g1_threads,
        "g2_dead_replica": {k: g2_dead.get(k) for k in ("scrapes", "scrape_failures",
                                                        "breaker_open", "headroom")},
    }
    # the shards the phase's server ran (its /metrics scans count them)
    result["server_shards"] = sum(r["stats"].get("fleet.replica_shards", {}).get(hosts[0], 0)
                                  for r in (g1, g2, g4))
    log({"phase": "server-fleet", **result})
    check(all(r["rc"] == 0 for r in (g1, sub_local, g2, g3, image_local, g4, iac_local, g5)),
          "server (g): a fleet leg's command failed")
    check(result["g5_equal_local"] and {"cloudformation", "helm"} <= set(result["g5_types"]),
          f"server (g5): misconfig fleet equal {result['g5_equal_local']}, types "
          f"{result['g5_types']}")
    check(result["g1_equal_local"], "server (g1): the fleet's Results differ from the local scan")
    check(result["g1_interval_s"] == 1.0 and sorted(g1_reps) == sorted(hosts)
          and all(rep["scrapes"] >= 1 and 0.0 <= rep["headroom"] <= 1.0
                  for rep in g1_reps.values()),
          f"server (g1): the fleet block {result['g1_headroom']} {result['g1_scrapes']}")
    check(any({"device_busy_ratio", "queue_depth"} <= set(rep["summary"])
              for rep in g1_reps.values()),
          "server (g1): no replica summary holds device_busy_ratio and queue_depth")
    check(not g1_rows and not g1_threads,
          f"server (g1): the plane outlived the scan: {g1_rows} {g1_threads}")
    check(g1_plane["timeseries"] is not None and sorted(g1_plane["timeseries"]["replicas"])
          == sorted(hosts), "server (g1): the --timeseries-out fleet block")
    check(not any("Degraded" in r["doc"] for r in (g1, g2, g4, g5)),
          "server (g): a live fleet's report is Degraded")
    check(all(g1["stats"]["fleet.replica_shards"][h] > 0 for h in hosts),
          f"server (g1): shards by replica {g1['stats']['fleet.replica_shards']}")
    check(result["g2_equal_local"] and g2_breaker == 1.0
          and g2["stats"]["fleet.replica_shards"][dead[0]] == 0,
          f"server (g2): equal {result['g2_equal_local']}, breaker {g2_breaker}")
    check((g2_dead.get("scrape_failures") or 0) >= 2 and g2_dead.get("breaker_open") is True,
          f"server (g2): the dead replica's block {result['g2_dead_replica']}")
    check(result["g3_equal_local"] and result["g3_degraded"] is True
          and g3["stats"]["fleet.local_fallback"] == g3["stats"]["fleet.shards"],
          f"server (g3): equal {result['g3_equal_local']}, Degraded {result['g3_degraded']}")
    check(g3_loud["rc"] == 1 and not g3_loud["doc"],
          f"server (g3): --no-host-fallback exited {g3_loud['rc']}")
    check(result["g4_equal_local"], "server (g4): the image fleet differs from the local scan")
    if device == "cuda":
        rep, fold = g1["launches"]["replicas"], g1["launches"]["fold"]
        check(all(rep.get(k, 0) > 0 for k in IMAGE_KERNELS) and not rep.get("verscmp", 0),
              f"server (g1): the replicas' launches {rep}")
        check(fold == {"verscmp": 1} and not g1["launches"]["fallback"],
              f"server (g1): the fold's launches {fold}")
        fb = g3["launches"]["fallback"]
        check(all(fb.get(k, 0) > 0 for k in IMAGE_KERNELS) and not g3["launches"]["replicas"],
              f"server (g3): the local fallback's launches {g3['launches']}")
        check(g4["launches"]["replicas"].get("prefilter", 0) > 0 and not g4["launches"]["fold"],
              f"server (g4): launches {g4['launches']}")
        check(all(g5["launches"]["replicas"].get(k, 0) > 0
                  for k in ("prefilter", "anchored", "decompress"))
              and not g5["launches"]["fallback"], f"server (g5): launches {g5['launches']}")
    return result


def phase_server(root: Path, fs_tree: Path, db_dir: Path, card: str,
                 device: str = "cuda") -> dict:
    """Client/server mode on the card: an in-process ``start_server`` with
    the cve DB detecting on ``device`` (``--max-concurrent-scans 2
    --admission-queue-depth 1``) and ``cli.main``'s ``fs --server`` as the
    client, analysing on ``device``. A local ``fs --scanners
    vuln,secret,license`` of the tree is the reference. (a) the client scan:
    the reference's ``Results``, the feed and license kernels launched by
    the client and ``verscmp`` by the server (launch counters to 0 just
    before, read just after); (b) a warm rescan: no blob sent, the server's
    trace shows no bound bytes uploaded; (c) four clients at once, each on
    its own lockfile subset, each equal to its serial scan (the subset 0's
    also to a local scan); (d) a burst of raw submits of the tree's blob past
    the queue: 429 or 503 with ``Retry-After``, and a submit's
    ``wait_result`` of subset 0's blob equal to its sync scan; (e) ``python -m trivy_tpu_torch server`` in a subprocess with
    a token: a client scan equal to (c)'s, a wrong token refused, SIGTERM
    drains it and it exits 0; (f) (b)'s ``--trace-out`` holds one trace id
    with the server's root span under the client's ``rpc.scan``, and
    ``GET /metrics`` parses with the port's ``parse_text``."""
    from trivy_tpu_torch.obs.metrics import parse_text
    from trivy_tpu_torch.rpc import SCAN_SUBMIT
    from trivy_tpu_torch.rpc.admission import resolve_admission
    from trivy_tpu_torch.rpc.client import RemoteCache, RemoteDriver, RPCError, get_metrics_text
    from trivy_tpu_torch.rpc.server import start_server
    from trivy_tpu_torch.scanner import ScanOptions
    from trivy_tpu_torch.types import Result

    t_phase = time.perf_counter()
    out = root / "out"
    out.mkdir(parents=True)
    subsets = server_subsets(fs_tree, root)
    head = ["fs", "--scanners", "vuln,secret,license", "--license-full", "--db-repository",
            str(db_dir), "--device", device, "--format", "json", "-q"]

    def run(tag: str, *extra: str) -> tuple[dict, dict, float, dict]:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        rc = cli.main([*head, "-o", str(out / f"{tag}.json"),
                       "--stats-out", str(out / f"{tag}.stats.json"), *extra, str(fs_tree)])
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        check(rc == 0, f"server: the {tag} scan exited {rc}")
        return (json.loads((out / f"{tag}.json").read_text()),
                json.loads((out / f"{tag}.stats.json").read_text()), seconds, launches)

    local, local_stats, local_s, _ = run("local")
    db = VulnDB.load(str(db_dir))
    cache = RecordingCache()
    httpd, port = start_server(cache=cache, vuln_client=db, device=device, admission=
                               resolve_admission({"max_concurrent_scans": 2,
                                                  "admission_queue_depth": 1}))
    url = f"http://127.0.0.1:{port}"
    result: dict = {"phase": "server", "card": card, "local_s": local_s,
                    "components": local_stats["components"]}
    try:
        # (a) the client scan; (b) the warm rescan, traced
        rep_a, stats_a, a_s, launches = run("client", "--server", url)
        upload_a = library._resident_join(db).upload_bytes
        rep_b, stats_b, b_s, launches_b = run(
            "warm", "--server", url, "--trace-out", str(out / "warm.trace.json"),
            "--metrics-out", str(out / "warm.metrics.json"))
        remote = json.loads((out / "warm.metrics.json").read_text())["remote"]
        trace = json.loads((out / "warm.trace.json").read_text())["traceEvents"]
        spans = [e for e in trace if e["ph"] == "X"]
        rpc_span = [e for e in spans if e["pid"] == 1 and e["name"] == "rpc.scan"]
        server_root = [e for e in spans if e["pid"] == 2 and e["name"] == "server.scan"]
        result.update({
            "client_s": a_s, "warm_s": b_s, "local_scan_s": local_stats["seconds"],
            "client_scan_s": stats_a["seconds"], "warm_scan_s": stats_b["seconds"],
            "client_over_local": stats_a["seconds"] / local_stats["seconds"],
            "client_components_per_s": local_stats["components"] / stats_a["seconds"],
            "local_components_per_s": local_stats["components"] / local_stats["seconds"],
            "client_detect_s": stats_a["detect.seconds"],
            "local_detect_s": local_stats["detect.seconds"],
            "launches": launches, "launches_warm": launches_b,
            "blobs_sent": [stats_a.get("remote.blobs_sent"), stats_b.get("remote.blobs_sent")],
            "bounds_bytes_uploaded": [upload_a, remote[0]["counters"].get(
                "cve.bounds_bytes_uploaded", 0)],
            "client_equal_local": rep_a["Results"] == local["Results"]
            and rep_a["Metadata"] == local["Metadata"],
            "warm_equal_local": rep_b["Results"] == local["Results"],
            "trace_ids": sorted({e["args"]["trace_id"] for e in spans}),
            "server_root_under_rpc_scan": bool(rpc_span and server_root) and all(
                e["args"].get("parent_span_id") == rpc_span[0]["args"]["span_id"]
                for e in server_root),
            "server_stall": {k: v for k, v in json.loads(
                (out / "warm.metrics.json").read_text())["stall"].items()
                if k.startswith("server:")},
        })
        # (c) concurrent clients, each on its own lockfile subset
        def subset_scan(t: int, url: str = url, token: str = "") -> list:
            report, _ = cli.scan_fs(str(subsets[t]), scanners=("vuln",), device=device,
                                    server=url, token=token)
            return report.to_dict()["Results"]

        serial = [subset_scan(t) for t in range(SERVER_CLIENTS)]
        local0, _ = cli.scan_fs(str(subsets[0]), scanners=("vuln",), device=device, db=db)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVER_CLIENTS) as pool:
            together = list(pool.map(subset_scan, range(SERVER_CLIENTS)))
        adm = httpd.service.admission
        result.update({
            "concurrent_s": time.perf_counter() - t0,
            "subset_vulnerabilities": [sum(len(r.get("Vulnerabilities", [])) for r in s)
                                       for s in serial],
            "concurrent_equal_serial": [a == b for a, b in zip(together, serial)],
            "subset0_equal_local": serial[0] == local0.to_dict()["Results"],
            "concurrency_sheds": adm.shed.value(tenant="default", reason="concurrency"),
        })
        # (d) a burst of submits past the queue, then one async job
        bid = cache.put_ids[0]
        body = {"Target": "burst", "ArtifactID": bid, "BlobIDs": [bid],
                "Options": {"Scanners": ["vuln"]}}
        with ThreadPoolExecutor(SERVER_BURST) as pool:
            burst = list(pool.map(lambda _i: post_json(url + SCAN_SUBMIT, body),
                                  range(SERVER_BURST)))
        driver = RemoteDriver(url)
        for code, doc, _h in burst:
            if code == 202:
                driver.wait_result(doc["JobID"], timeout=300)
        # the sync and async scans of subset 0's blob (the second one put)
        sub_bid = cache.put_ids[1]
        sync, _os = driver.scan("subset0", sub_bid, [sub_bid], ScanOptions(scanners=["vuln"]))
        sub = driver.submit("subset0", sub_bid, [sub_bid], ScanOptions(scanners=["vuln"]))
        job = driver.wait_result(sub["JobID"], timeout=300)
        shed = [(code, h.get("Retry-After")) for code, _d, h in burst if code != 202]
        result.update({
            "burst_codes": sorted(code for code, _d, _h in burst),
            "burst_retry_after": [ra for _c, ra in shed],
            # both read through the client's Result type, as scan_async does
            "async_equal_sync": [Result.from_dict(r).to_dict() for r in job.get("Results", [])]
            == [r.to_dict() for r in sync],
        })
        # (g) the fleet through the port's coordinator
        result["fleet"] = fleet_leg(url, root, fs_tree, db_dir, device, local, local_s)
        metrics = parse_text(get_metrics_text(url))
        result["metrics_scans"] = metrics["trivy_tpu_scans_total"].first()
    finally:
        httpd.shutdown()
    # (e) the server command in a subprocess, with a token
    port2 = free_port()
    url2 = f"http://127.0.0.1:{port2}"
    t0 = time.perf_counter()
    with open(root / "server.log", "wb") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "trivy_tpu_torch", "server", "--listen", f"127.0.0.1:{port2}",
             "--device", device, "--db-repository", str(db_dir), "--cache-dir",
             str(root / "srv-cache"), "--token", "T"],
            cwd=str(REPO), stdout=logf, stderr=subprocess.STDOUT)
        try:
            healthy = False
            deadline = time.monotonic() + 180
            while not healthy and time.monotonic() < deadline and proc.poll() is None:
                try:
                    with urllib.request.urlopen(url2 + "/healthz", timeout=2) as r:
                        healthy = json.loads(r.read()).get("Status") == "ok"
                except OSError:
                    time.sleep(0.2)
            result["subprocess_ready_s"] = time.perf_counter() - t0
            check(healthy, f"server: the subprocess server never answered /healthz "
                           f"(exit {proc.poll()}): {(root / 'server.log').read_text()[-2000:]}")
            result["subprocess_equal"] = subset_scan(0, url2, "T") == serial[0]
            try:
                RemoteCache(url2, token="wrong", retries=0).missing_blobs("x", ["x"])
                result["wrong_token"] = "accepted"
            except RPCError as e:
                result["wrong_token"] = str(e)
            proc.send_signal(signal.SIGTERM)
            result["subprocess_rc"] = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    result["seconds"] = time.perf_counter() - t_phase
    log(result)
    check(result["client_equal_local"] and result["warm_equal_local"],
          "server: the client/server Results differ from the local scan")
    if device == "cuda":
        check(all(launches.get(k, 0) > 0 for k in (*IMAGE_KERNELS, "verscmp")),
              f"server: kernels not launched in the client/server scan: {launches}")
    check(result["blobs_sent"] == [1, 0], f"server: blobs sent {result['blobs_sent']}")
    check(upload_a > 0 and result["bounds_bytes_uploaded"][1] == 0,
          f"server: bound bytes uploaded {result['bounds_bytes_uploaded']}")
    check(len(result["trace_ids"]) == 1 and result["server_root_under_rpc_scan"],
          f"server: trace ids {result['trace_ids']}, server root under rpc.scan "
          f"{result['server_root_under_rpc_scan']}")
    check(all(result["concurrent_equal_serial"]) and result["subset0_equal_local"],
          f"server: concurrent {result['concurrent_equal_serial']}, "
          f"subset 0 local {result['subset0_equal_local']}")
    check(all(n > 0 for n in result["subset_vulnerabilities"])
          and len({json.dumps(s) for s in serial}) == SERVER_CLIENTS,
          f"server: subsets {result['subset_vulnerabilities']}")
    check(bool(shed) and all(c in (429, 503) and ra for c, ra in shed),
          f"server: burst codes {result['burst_codes']}, Retry-After {result['burst_retry_after']}")
    check(result["async_equal_sync"], "server: the async job differs from the sync scan")
    check(result["metrics_scans"] >= 2 + 2 * SERVER_CLIENTS + result["fleet"]["server_shards"],
          f"server: /metrics counted {result['metrics_scans']} scans")
    check(result["subprocess_equal"], "server: the subprocess server's Results differ")
    check("401" in result["wrong_token"], f"server: wrong token {result['wrong_token']}")
    check(result["subprocess_rc"] == 0, f"server: the subprocess exited {result['subprocess_rc']}")
    return result


# the image's history: the first layer is the base image's (an empty-layer
# CMD ends it), so its secret scan is skipped
IMAGE_HISTORY = [
    {"created_by": "/bin/sh -c #(nop) ADD file:debian-12-rootfs.tar.xz in / "},
    {"created_by": '/bin/sh -c #(nop)  CMD ["bash"]', "empty_layer": True},
    {"created_by": "COPY services crates py web src /"},
    {"created_by": "COPY lic hdr app legacy src /"},
    {"created_by": "RUN rm -rf /app/drop.env /services/removed /legacy/* # buildkit"},
    {"created_by": "COPY motd /etc/motd # buildkit"},
]
# the paths the whiteout layer removes, each holding a plant
IMAGE_REMOVED = ("app/drop.env", "services/removed/package-lock.json", "legacy/keys.py")


def layer_tar(root: Path | None, keep=lambda rel: True, extra: dict | None = None) -> bytes:
    """An uncompressed layer tar of the files under ``root`` (if any) that
    ``keep`` selects, and of ``extra`` ({path: bytes}), in sorted order."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for p in sorted(root.rglob("*")) if root is not None else ():
            rel = p.relative_to(root).as_posix()
            if p.is_file() and keep(rel):
                tf.add(p, arcname=rel)
        for rel, data in (extra or {}).items():
            info = tarfile.TarInfo(rel)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def write_image_layers(root: Path, seed: int, base: bytes, mib: int) -> dict:
    """The image's layer directories under ``root``, about ``mib`` MiB in
    all: ``base`` (debian 12 and a secret), ``apps`` (the fs-vuln tree but
    its OS root, and a lockfile with a plant that a whiteout removes),
    ``content`` (the license tree filling the rest, planted secrets, and the
    files the whiteouts remove), ``top``. Returns the plants: secrets as (path, rule, line),
    licenses as {path: name}, and the secrets that must not be reported."""
    _n_comp, fs_secrets = write_fs_tree(root / "apps", seed, base)
    for rel in ("etc/os-release", "var/lib/dpkg/status"):
        dst = root / "base" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        (root / "apps" / rel).rename(dst)
    rng = random.Random(seed + 11)
    ids = sorted(SAMPLES)

    def planted(layer: str, rel: str) -> tuple:
        rid = ids[rng.randrange(len(ids))]
        body = base[:4096]
        cut = body.rfind(b"\n", 0, rng.randrange(1, len(body))) + 1
        path = root / layer / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(body[:cut] + SAMPLES[rid].encode() + b"\n" + body[cut:])
        return (rel, rid, body[:cut].count(b"\n") + 1)

    hidden = [planted("base", "etc/base.env")]
    ptype, _bucket, name, _vid, vuln, _hi = plants()[0]
    check(ptype == "npm", f"image: the first plant is {ptype}, not npm")
    removed = root / "apps" / "services" / "removed" / "package-lock.json"
    removed.parent.mkdir(parents=True)
    removed.write_text(json.dumps({"name": "removed", "lockfileVersion": 3, "packages": {
        "": {"name": "removed", "dependencies": {name: "*"}},
        f"node_modules/{name}": {"version": vuln}}}))
    apps_mib = sum(f.stat().st_size for f in (root / "apps").rglob("*") if f.is_file()) >> 20
    licenses, _written = write_license_tree(root / "content", max(1, mib - apps_mib), seed,
                                            base, license_files=IMAGE_LICENSE_FILES)
    secrets = fs_secrets + [planted("content", f"app/settings_{i}.py") for i in range(4)]
    hidden += [planted("content", "app/drop.env"), planted("content", "legacy/keys.py")]
    top = root / "top" / "etc" / "motd"
    top.parent.mkdir(parents=True)
    top.write_text("built by chip_smoke.py\n")
    return {"secrets": secrets, "licenses": licenses, "hidden": hidden}


def build_image(root: Path, out: Path, keep=lambda layer, rel: True, oci: bool = False) -> int:
    """The image archive of the layer directories under ``root`` (the files
    ``keep(layer, rel)`` selects) at ``out``: docker-save, or an OCI layout
    directory with gzip layers. Returns its layer bytes (uncompressed)."""
    layers = [layer_tar(root / d, lambda rel, d=d: keep(d, rel))
              for d in ("base", "apps", "content")]
    layers.append(layer_tar(None, extra={
        "app/.wh.drop.env": b"", "services/removed/.wh.package-lock.json": b"",
        "legacy/.wh..wh..opq": b""}))
    layers.append(layer_tar(root / "top"))
    env = ["PATH=/usr/local/bin:/usr/bin", f"GITHUB_TOKEN={SAMPLES['github-pat']}"]
    if oci:
        IMAGES["oci_layout_dir"](str(out), layers, history=IMAGE_HISTORY, env=env,
                                 compress=True)
    else:
        IMAGES["docker_save_tar"](str(out), layers, history=IMAGE_HISTORY, env=env,
                                  repo_tag="chip-smoke/app:latest")
    return sum(len(l) for l in layers)


def small_image_keep(root: Path, mib: int):
    """``keep`` for the small image: the base and top layers whole, a few
    lockfiles, the fs tree's first source file, the license tree's subset,
    the planted and removed files, and source text up to ``mib`` MiB."""
    apps = ("services/web00/", "services/go00/", "crates/c00/", "py/", "src/module_0.py",
            "services/removed/")
    content = ("sub/", "app/", "legacy/")
    kept = {("content", f.relative_to(root / "content").as_posix())
            for f in (root / "content").rglob("*") if f.is_file()
            and f.relative_to(root / "content").as_posix().startswith(content)}
    size = sum((root / d / rel).stat().st_size for d, rel in kept)
    for d, prefixes in (("base", ("",)), ("apps", apps), ("top", ("",))):
        for f in (root / d).rglob("*"):
            rel = f.relative_to(root / d).as_posix()
            if f.is_file() and rel.startswith(prefixes):
                kept.add((d, rel))
                size += f.stat().st_size
    for f in sorted((root / "content").glob("src*/module_*.py")):
        if size >= mib << 20:
            break
        kept.add(("content", f.relative_to(root / "content").as_posix()))
        size += f.stat().st_size
    return lambda layer, rel: (layer, rel) in kept


def image_stats(st: dict) -> dict:
    """One image scan's counters: layers, layer MB/s, components/s and
    the seconds of walk and analysis against detection."""
    return {
        "seconds": st["seconds"], "layers": st["layers"],
        "layers_analyzed": st["layers_analyzed"], "layers_cached": st["layers_cached"],
        "layer_bytes": st["layer_bytes"], "layer_MBps": st["layer_bytes"] / st["seconds"] / 1e6,
        "components": st["components"], "components_per_s": st["components"] / st["seconds"],
        "analyze_s": st["analyze.seconds"], "detect_s": st["detect.seconds"],
        "files_walked": st["files_walked"], "files_scanned": st["files_scanned"],
        "dispatches": st["cve.dispatch_count"], "dispatch_s": st["cve.dispatch.seconds"],
        "rows": st["rows"], "batches": st["batches"],
    }


def phase_image(root: Path, db_dir: Path, seed: int, base: bytes, mib: int,
                card: str) -> tuple[dict, dict, dict]:
    """``cli.scan_image`` with ``vuln,secret,license --license-full`` on the
    card over the seeded image, twice on one layer cache (launch counters to
    0 just before each scan, read just after); then the 8 MiB cut on the
    card, on the CPU, and as an OCI layout with gzip layers on the card.
    Returns the phase's result and the reports of the first scan and of the
    cut on the card."""
    t0 = time.perf_counter()
    plants_ = write_image_layers(root / "layers", seed, base, mib)
    layer_bytes = build_image(root / "layers", root / "image.tar")
    setup_s = time.perf_counter() - t0
    db = VulnDB.load(str(db_dir))
    library._resident_join(db)
    kw = dict(scanners=("vuln", "secret", "license"), license_full=True, db=db)
    scans = []
    for _ in range(2):
        LAUNCHES.clear()
        report, stats = cli.scan_image(str(root / "image.tar"), device="cuda",
                                       cache_dir=str(root / "cache"), **kw)
        scans.append((report.to_dict(), stats, dict(LAUNCHES)))
    (report, stats, launches), (again, stats2, launches2) = scans
    found_v = {(v["PkgName"], v["VulnerabilityID"], v["InstalledVersion"])
               for r in report["Results"] for v in r.get("Vulnerabilities", [])}
    missed = [p for p in plants() if (p[2], p[3], p[4]) not in found_v]
    patched = [p for p in plants() if any(k[0] == p[2] and k[2] == p[5] for k in found_v)]
    secrets = found(report)
    want = {("/" + rel, rid, line) for rel, rid, line in plants_["secrets"]}
    missed_secrets = sorted(want - secrets)
    targets = {r["Target"] for r in report["Results"]}
    gone = set(IMAGE_REMOVED) | {rel for rel, _r, _l in plants_["hidden"]}
    leaked = sorted(t for t in targets if t.lstrip("/") in gone)
    got_lic = licenses_found(report)
    missed_lic = sorted(rel for rel, key in plants_["licenses"].items()
                        if key not in got_lic.get(rel, ()))
    # the cut: card, CPU, and its OCI layout with gzip layers
    keep = small_image_keep(root / "layers", IMAGE_CUT_MIB)
    small_bytes = build_image(root / "layers", root / "small.tar", keep)
    build_image(root / "layers", root / "small-oci", keep, oci=True)
    small = {}
    for tag, path, device in (("cuda", "small.tar", "cuda"), ("cpu", "small.tar", "cpu"),
                              ("oci", "small-oci", "cuda")):
        rep, st = cli.scan_image(str(root / path), device=device,
                                 cache_dir=str(root / f"cache-{tag}"), **kw)
        small[tag] = (rep.to_dict(), st)
    card_r, cpu_r, oci_r = (small[k][0] for k in ("cuda", "cpu", "oci"))
    oci_results = json.loads(json.dumps(oci_r["Results"]).replace(
        json.dumps(oci_r["ArtifactName"])[1:-1], json.dumps(card_r["ArtifactName"])[1:-1]))
    result = {
        "phase": "image", "layer_bytes": layer_bytes, "setup_s": setup_s,
        "scan": image_stats(stats), "cached_scan": image_stats(stats2),
        "feed": feed_counters(stats), **gate_counters(stats), "launches": launches,
        "launches_cached": launches2, "results": len(report["Results"]),
        "findings": len(found_v), "planted": len(plants()), "missed": missed[:5],
        "patched_reported": patched[:5], "secrets_planted": len(want),
        "secrets_missed": missed_secrets[:5], "leaked": leaked[:5],
        "env_secret": "container image config (env)" in targets,
        "licenses_planted": len(plants_["licenses"]), "licenses_missed": missed_lic[:5],
        "cached_equal": again["Results"] == report["Results"],
        "os": report["Metadata"].get("OS"), "diff_ids": len(report["Metadata"]["DiffIDs"]),
        "small_layer_bytes": small_bytes,
        "small": {k: image_stats(st) for k, (_r, st) in small.items()},
        "small_cpu_equal": all(card_r[k] == cpu_r[k] for k in ("Results", "Metadata")),
        "small_oci_equal": oci_results == card_r["Results"],
        "card": card,
    }
    log(result)
    check(not missed, f"image: {len(missed)} planted vulnerable components not reported")
    check(not patched, f"image: {len(patched)} components at their patched version reported")
    check(not missed_secrets, f"image: planted secrets not reported: {missed_secrets[:5]}")
    check(not leaked, f"image: removed or base-layer findings reported: {leaked[:5]}")
    check(result["env_secret"], "image: the ENV secret was not reported")
    check(not missed_lic, f"image: planted licenses not reported: {missed_lic[:5]}")
    check((result["os"] or {}).get("Family") == "debian", "image: Metadata.OS missing")
    check(all(launches.get(k, 0) > 0 for k in (*IMAGE_KERNELS, "verscmp")),
          f"image: a kernel was not launched on the main path: {launches}")
    check(launches.get("verscmp") == 1, f"image: verscmp launched {launches.get('verscmp')}")
    check(stats2["layers_analyzed"] == 0 and stats2["layers_cached"] == stats["layers"],
          f"image: the cached scan analyzed {stats2['layers_analyzed']} layers")
    check(not any(launches2.get(k, 0) for k in IMAGE_KERNELS),
          f"image: the cached scan launched a feed or license kernel: {launches2}")
    check(result["cached_equal"], "image: Results differ on the cached scan")
    check(result["small_cpu_equal"], "image: the cut's Results or Metadata differ on the CPU")
    check(result["small_oci_equal"], "image: the OCI layout's Results differ from docker-save's")
    return result, report, card_r


def load_fake(name: str):
    """``tests/<name>.py`` loaded by path as the module ``tests.<name>``: the
    registry fake imports ``tests.imagetest``, and a package named ``tests``
    installed on the machine would shadow the checkout's directory."""
    spec = importlib.util.spec_from_file_location(f"tests.{name}", REPO / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


OCI_MANIFEST = "application/vnd.oci.image.manifest.v1+json"


def archive_layers(path: Path) -> tuple[list, bytes]:
    """The uncompressed layer tars and the config of an image archive."""
    archive = _ImageArchive(str(path))
    try:
        layers = []
        for i in range(len(archive.diff_ids)):
            with archive.layer_stream(i) as f:
                layers.append(f.read())
        return layers, archive.config_bytes
    finally:
        archive.close()


def push_image(reg, repo: str, ref: str, layers: list, config: bytes) -> str:
    """An OCI manifest of gzip (level 1) ``layers`` and ``config`` pushed
    under ``ref``; returns its digest."""
    descs = []
    for layer in layers:
        blob = gzip.compress(layer, compresslevel=1)
        descs.append({"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
                      "digest": reg.put_blob(repo, blob), "size": len(blob)})
    return reg.put_manifest(repo, ref, {
        "schemaVersion": 2, "mediaType": OCI_MANIFEST,
        "config": {"mediaType": "application/vnd.oci.image.config.v1+json",
                   "digest": reg.put_blob(repo, config), "size": len(config)},
        "layers": descs}, OCI_MANIFEST)


def renamed(report: dict, name: str) -> list:
    """``report``'s Results with its artifact name (in the OS target) as
    ``name``."""
    old = json.dumps(report["ArtifactName"])[1:-1]
    return json.loads(json.dumps(report["Results"]).replace(old, json.dumps(name)[1:-1]))


GIT_ENV = {"GIT_AUTHOR_NAME": "smoke", "GIT_AUTHOR_EMAIL": "smoke@example.com",
           "GIT_COMMITTER_NAME": "smoke", "GIT_COMMITTER_EMAIL": "smoke@example.com",
           "GIT_CONFIG_NOSYSTEM": "1", "GIT_CONFIG_GLOBAL": os.devnull}


def git(cwd: Path, *args: str, stdin: bytes | None = None) -> None:
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), **GIT_ENV}
    subprocess.run(["git", *args], cwd=cwd, env=env, input=stdin, check=True,
                   capture_output=True)


def git_commit_tree(tree: Path) -> None:
    """``tree`` made a git worktree with every file in one commit, written
    as one pack by ``git fast-import``: ``git add`` writes an object file per
    file, which on a 9p filesystem, where creating a file costs
    milliseconds, took 10 s for the fs-vuln tree's 2,073 files."""
    chunks = [b"commit refs/heads/main\ncommitter smoke <smoke@example.com> 0 +0000\n"
              b"data 4\nbase\n"]
    for d, dirs, names in os.walk(tree):
        dirs[:] = sorted(x for x in dirs if x != ".git")
        for name in sorted(names):
            path = Path(d) / name
            data = path.read_bytes()
            chunks.append(f"M 100644 inline {path.relative_to(tree).as_posix()}\n"
                          f"data {len(data)}\n".encode())
            chunks.append(data + b"\n")
    git(tree, "init", "-q", "-b", "main")
    git(tree, "fast-import", "--quiet", stdin=b"".join(chunks))
    git(tree, "reset", "-q")  # the index, from the commit and the files' stat


# phase sources' leg (f): node-collector output in the cluster dump, one
# node passing and one failing the kubelet checks
NODE_INFO = {
    "kubeletServiceFilePermissions": {"values": [600]},
    "kubeletServiceFileOwnership": {"values": ["root:root"]},
    "kubeletConfFilePermissions": {"values": [600]},
    "kubeletAnonymousAuthArgumentSet": {"values": ["false"]},
    "kubeletAuthorizationModeArgumentSet": {"values": ["Webhook"]},
    "kubeletReadOnlyPortArgumentSet": {"values": ["0"]},
    "kubeletRotateCertificatesArgumentSet": {"values": ["true"]},
}
K8S_KINDS = ("Pod", "Deployment", "StatefulSet", "DaemonSet", "ReplicaSet", "Job", "CronJob")


def k8s_dump(path: Path, images: list[str], seed: int, n: int = 20) -> None:
    """A ``kubectl get -o json`` dump of ``n`` workloads of every kind over
    ``images`` (some privileged, some on the host network, one with a token
    in its environment), a Service and two ``NodeInfo`` documents."""
    rng = random.Random(seed)
    items = []
    for i in range(n):
        kind = K8S_KINDS[i % len(K8S_KINDS)]
        c = {"name": f"c{i}", "image": images[i % len(images)]}
        if rng.random() < 0.4:
            c["securityContext"] = {"privileged": True}
        if i == 3:
            c["env"] = [{"name": "TOKEN", "value": SAMPLES["github-pat"]}]
        spec = {"containers": [c], **({"hostNetwork": True} if rng.random() < 0.3 else {})}
        body = (spec if kind == "Pod" else
                {"schedule": "0 * * * *", "jobTemplate": {"spec": {"template": {"spec": spec}}}}
                if kind == "CronJob" else {"template": {"spec": spec}})
        items.append({"apiVersion": "v1" if kind == "Pod" else "apps/v1", "kind": kind,
                      "metadata": {"name": f"w{i:02d}",
                                   "namespace": rng.choice(["default", "prod"])},
                      "spec": body})
    bad = {**NODE_INFO, "kubeletAnonymousAuthArgumentSet": {"values": ["true"]}}
    items += [{"apiVersion": "v1", "kind": "Service", "metadata": {"name": "svc"}},
              *({"apiVersion": "v1", "kind": "NodeInfo", "type": "node-collector",
                 "metadata": {"name": name}, "info": info}
                for name, info in (("worker-1", NODE_INFO), ("worker-2", bad)))]
    path.write_text(json.dumps({"apiVersion": "v1", "kind": "List", "items": items}))


def sources_k8s(root: Path, seed: int) -> dict:
    """Phase sources' leg (f): ``k8s --manifests <dump> --scan-images`` of
    about twenty workloads and a ``NodeInfo`` over two images of a tokenless
    in-process registry (a ``package-lock.json`` of 602 packages, two of
    them vulnerable, and a token; a clean one) and an image no registry
    holds, with the fixture DB of
    ``tests/dbtest.py``, on the card (launch counters to 0 just before,
    read just after) and on the CPU: equal JSON, the images' findings, an
    error row for the missing one; then ``--compliance k8s-nsa-1.0`` on
    both. The feed's kernels and ``verscmp`` must launch."""
    t_leg = time.perf_counter()
    load_fake("imagetest")  # the registry fake imports it
    registrytest, dbtest = load_fake("registrytest"), load_fake("dbtest")
    db_dir = dbtest.build_db(root / "k8s-db")
    reg = registrytest.MemoryRegistry()

    def config(layer: bytes) -> bytes:
        return json.dumps({"architecture": "amd64", "os": "linux", "config": {},
                           "rootfs": {"type": "layers",
                                      "diff_ids": [registrytest.digest_of(layer)]}}).encode()

    web = layer_tar(None, extra={
        "etc/alpine-release": b"3.18.4\n",
        # past the join's batch threshold (512 packages), so that the CVE
        # join runs on the card as in a real application image
        "app/package-lock.json": json.dumps({"lockfileVersion": 3, "packages": {
            "node_modules/lodash": {"version": "4.17.15"},
            "node_modules/minimist": {"version": "1.2.0"},
            **{f"node_modules/dep-{i:03d}": {"version": f"1.{i % 7}.{i}"}
               for i in range(600)}}}).encode(),
        "app/settings.env": f"DEPLOY_TOKEN={SAMPLES['github-pat']}\n".encode()})
    clean = layer_tar(None, extra={"etc/alpine-release": b"3.18.4\n",
                                   "app/main.py": b"print('hello')\n" * 64})
    push_image(reg, "k8s/web", "1", [web], config(web))
    push_image(reg, "k8s/clean", "2", [clean], config(clean))
    server, host = registrytest.start_registry(reg)
    dump = root / "k8s-dump.json"
    k8s_dump(dump, [f"{host}/k8s/web:1", f"{host}/k8s/clean:2", "127.0.0.1:9/k8s/gone:1"],
             seed)
    docs, launches, seconds = {}, {}, {}
    try:
        for device in ("cuda", "cpu"):
            for tag, extra in (("images", ["--scan-images", "--insecure", "--db-repository",
                                           str(db_dir)]),
                               ("nsa", ["--compliance", "k8s-nsa-1.0"])):
                out = root / f"k8s-{tag}-{device}.json"
                LAUNCHES.clear()
                t0 = time.perf_counter()
                rc = cli.main(["k8s", "--manifests", str(dump), "--format", "json", "-o",
                               str(out), "--device", device, *extra])
                seconds[f"{tag}-{device}"] = time.perf_counter() - t0
                launches[f"{tag}-{device}"] = dict(LAUNCHES)
                check(rc == 0, f"sources (f): k8s {tag} on {device} exited {rc}")
                docs[f"{tag}-{device}"] = json.loads(out.read_text())
    finally:
        server.shutdown()
    card = docs["images-cuda"]
    rows = {r["Image"]: r for r in card["Images"]}
    web_ids = {f.get("VulnerabilityID") or f.get("RuleID")
               for f in rows.get(f"{host}/k8s/web:1", {}).get("Findings", [])}
    leg = {"workloads": len(card["Resources"]), "images": len(card["Images"]),
           "kinds": sorted({r["Kind"] for r in card["Resources"]}),
           "web_findings": sorted(web_ids),
           "seconds": seconds, "launches": launches["images-cuda"],
           "nsa": docs["nsa-cuda"]["SummaryControls"],
           "equal_to_cpu": docs["images-cuda"] == docs["images-cpu"],
           "nsa_equal_to_cpu": docs["nsa-cuda"] == docs["nsa-cpu"]}
    leg["leg_seconds"] = time.perf_counter() - t_leg
    log({"phase": "sources-k8s", **leg})
    check(leg["equal_to_cpu"] and leg["nsa_equal_to_cpu"],
          "sources (f): k8s JSON differs between card and CPU")
    check(leg["workloads"] == 22 and "NodeInfo" in leg["kinds"],
          f"sources (f): {leg['workloads']} rows of kinds {leg['kinds']}")
    check({"CVE-2021-23337", "github-pat"} <= web_ids, f"sources (f): web findings {web_ids}")
    check(bool(rows.get("127.0.0.1:9/k8s/gone:1", {}).get("Error")),
          "sources (f): the missing image has no error row")
    check(all(leg["launches"].get(k, 0) > 0 for k in ("prefilter", "anchored", "decompress",
                                                       "verscmp")),
          f"sources (f): a kernel was not launched by the image scans: {leg['launches']}")
    check(not any(launches["nsa-cuda"].values()),
          f"sources (f): --compliance launched a kernel: {launches['nsa-cuda']}")
    return leg


def phase_sources(root: Path, image_root: Path, fs_tree: Path, db_dir: Path, fs_secrets: list,
                  first: dict, cut: dict, card: str) -> dict:
    """The image targets that are not archives, then ``repo`` and ``vm``, on
    the card. (a) The ``image`` phase's five layers and config, gzip level 1,
    in the in-process registry with bearer-token auth under an index of two
    platforms: ``image <ref> --image-src remote --platform linux/amd64``
    through ``cli.main`` on a fresh cache (launch counters to 0 just before,
    read just after) must give the first archive scan's Results (names
    aside), then on that scan's layer cache analyze no layer. (b) The 8 MiB
    cut served by the fake Docker daemon on a unix socket: ``docker://``
    must give the cut's Results and leave no temp archive. (c) The cut with
    a new top layer (a planted secret and a vulnerable lockfile) scanned
    with ``--diff-base`` the cut: only the new layer walked, the Results of
    a plain scan, both plants reported. (d) A git repository of the
    checkout's code: ``repo file://... --branch`` equals ``fs`` of its tree.
    (e) ``mkfs.ext4 -d`` of the fs-vuln tree with the trace phase's license
    files: ``vm`` on the card equals the CPU (a child process running beside
    the card's scans), every plant reported, all six kernels launched; the
    rescan a cache hit. (f) ``k8s`` (:func:`sources_k8s`)."""
    t_phase = time.perf_counter()
    os.environ.pop("DOCKER_HOST", None)  # never the machine's own daemon
    load_fake("imagetest")
    registrytest, daemontest = load_fake("registrytest"), load_fake("daemontest")
    db = VulnDB.load(str(db_dir))
    library._resident_join(db)
    kw = dict(scanners=("vuln", "secret", "license"), license_full=True, db=db)
    result: dict = {"phase": "sources", "card": card}

    # (a) registry, at the full size
    t0 = time.perf_counter()
    layers, config = archive_layers(image_root / "image.tar")
    cut_layers, cut_config = archive_layers(image_root / "small.tar")
    reg = registrytest.MemoryRegistry(token="chip-smoke-token")
    amd64 = push_image(reg, "app", "amd64", layers, config)
    arm64 = push_image(reg, "app", "arm64", cut_layers, cut_config)
    reg.put_manifest("app", "1", {"schemaVersion": 2, "manifests": [
        {"mediaType": OCI_MANIFEST, "digest": d, "platform": {"os": "linux", "architecture": a}}
        for a, d in (("amd64", amd64), ("arm64", arm64))]},
        "application/vnd.oci.image.index.v1+json")
    server, host = registrytest.start_registry(reg)
    try:
        push_s = time.perf_counter() - t0
        ref = f"{host}/app:1"
        t0 = time.perf_counter()
        img = RegistryImage(ref, insecure=True, platform="linux/amd64")
        for desc in img.manifest["layers"]:
            img.client.blob_file(img.repository, desc["digest"]).close()
        pull_s = time.perf_counter() - t0

        def registry_scan(tag: str, cache: Path) -> tuple[dict, dict, dict]:
            out, st = root / f"{tag}.json", root / f"{tag}.stats.json"
            LAUNCHES.clear()
            rc = cli.main(["image", "--image-src", "remote", "--insecure", "--platform",
                           "linux/amd64", "--scanners", "vuln,secret,license",
                           "--license-full", "--db-repository", str(db_dir),
                           "--cache-dir", str(cache), "--format", "json", "-o", str(out),
                           "--stats-out", str(st), "--device", "cuda", "-q", ref])
            launches = dict(LAUNCHES)
            check(rc == 0, f"sources: registry scan ({tag}) exited {rc}")
            return json.loads(out.read_text()), json.loads(st.read_text()), launches

        reg_report, reg_stats, launches = registry_scan("registry", root / "cache-registry")
        _again, cached_stats, launches_cached = registry_scan("registry-cached",
                                                              image_root / "cache")
    finally:
        server.shutdown()
    raw_bytes = sum(len(l) for l in layers)
    reg_results_equal = renamed(reg_report, first["ArtifactName"]) == first["Results"]
    result["registry"] = {
        "ref": ref, "push_s": push_s, "pull_s": pull_s, "seconds": reg_stats["seconds"],
        "analyze_s": reg_stats["analyze.seconds"], "detect_s": reg_stats["detect.seconds"],
        "db_load_s": reg_stats.get("db_load_seconds"), "layers": reg_stats["layers"],
        "layer_bytes_gzip": reg_stats["layer_bytes"], "layer_bytes_raw": raw_bytes,
        "layer_MBps_gzip": reg_stats["layer_bytes"] / reg_stats["seconds"] / 1e6,
        "layer_MBps_raw": raw_bytes / reg_stats["seconds"] / 1e6,
        "pull_MBps_gzip": reg_stats["layer_bytes"] / pull_s / 1e6,
        "components": reg_stats["components"], "launches": launches,
        "results_equal_to_archive": reg_results_equal,
        "cached": {"seconds": cached_stats["seconds"],
                   "layers_analyzed": cached_stats["layers_analyzed"],
                   "launches": launches_cached},
    }
    result["launches_registry"] = launches

    # (b) the cut from the fake docker daemon
    t0 = time.perf_counter()
    daemon = daemontest.FakeDockerDaemon(str(root / "docker.sock")).start()
    tmp_dir = Path(tempfile.gettempdir())
    exports_before = set(tmp_dir.glob("trivy-tpu-daemon-*"))
    try:
        daemon.add_image("app:cut", (image_root / "small.tar").read_bytes())
        src = ImageSourceOption(image_src=["docker"], docker_host=f"unix://{daemon.socket_path}")
        LAUNCHES.clear()
        d_report, d_stats = cli.scan_image("docker://app:cut", device="cuda",
                                           cache_dir=str(root / "cache-daemon"),
                                           image_source=src, **kw)
        d_launches = dict(LAUNCHES)
    finally:
        daemon.stop()
    d_report = d_report.to_dict()
    result["daemon"] = {
        "seconds": d_stats["seconds"], "phase_s": time.perf_counter() - t0,
        "layers_analyzed": d_stats["layers_analyzed"], "launches": d_launches,
        "results_equal_to_cut": d_report["Results"] == cut["Results"],
        "temp_archives_left": len(set(tmp_dir.glob("trivy-tpu-daemon-*")) - exports_before),
    }

    # (c) --diff-base: the cut with one new layer
    t0 = time.perf_counter()
    ptype, _bucket, name, vid, vuln, _hi = plants()[0]
    secret = SAMPLES["github-pat"]
    new_layer = layer_tar(None, extra={
        "app/derived/settings.env": f"DEPLOY_TOKEN={secret}\n".encode(),
        "app/derived/package-lock.json": json.dumps({
            "name": "derived", "lockfileVersion": 3, "packages": {
                "": {"name": "derived", "dependencies": {name: "*"}},
                f"node_modules/{name}": {"version": vuln}}}).encode()})
    derived = root / "derived.tar"
    IMAGES["docker_save_tar"](str(derived), cut_layers + [new_layer],
                              history=IMAGE_HISTORY + [{"created_by": "COPY derived /app"}],
                              env=json.loads(cut_config)["config"]["Env"],
                              repo_tag="chip-smoke/derived:1")
    LAUNCHES.clear()
    diff_report, diff_stats = cli.scan_image(str(derived), device="cuda",
                                             diff_base=str(image_root / "small.tar"),
                                             cache_dir=str(root / "cache-diff"), **kw)
    diff_launches = dict(LAUNCHES)
    plain_report, plain_stats = cli.scan_image(str(derived), device="cuda",
                                               cache_dir=str(root / "cache-plain"), **kw)
    diff_report, plain_report = diff_report.to_dict(), plain_report.to_dict()
    got_secrets = {(t, rule) for t, rule, _line in found(diff_report)}
    got_vulns = {(r["Target"], v["VulnerabilityID"]) for r in diff_report["Results"]
                 for v in r.get("Vulnerabilities", [])}
    result["diff_base"] = {
        "seconds": diff_stats["seconds"], "plain_seconds": plain_stats["seconds"],
        "phase_s": time.perf_counter() - t0, "layers_seeded": diff_stats["layers_seeded"],
        "layers_analyzed": diff_stats["layers_analyzed"],
        "files_walked": diff_stats["files_walked"], "launches": diff_launches,
        "results_equal_to_plain": diff_report["Results"] == plain_report["Results"],
        "secret_reported": ("/app/derived/settings.env", "github-pat") in got_secrets,
        "vuln_reported": ("app/derived/package-lock.json", vid) in got_vulns,
    }
    check(ptype == "npm", f"sources: the first plant is {ptype}, not npm")

    # (d) repo: a git repository of the checkout's code
    t0 = time.perf_counter()
    repo_src = root / "repo-src"
    for src_dir, dst in REPO_TREES.items():
        shutil.copytree(REPO / src_dir, repo_src / dst, ignore=shutil.ignore_patterns("__pycache__"))
    git(repo_src, "init", "-q", "-b", "smoke")
    git(repo_src, "add", "-A")
    git(repo_src, "commit", "-q", "-m", "smoke")
    repo_reports = {}
    for cmd, target in (("repo", f"file://{repo_src}"), ("fs", str(repo_src))):
        out = root / f"{cmd}.json"
        LAUNCHES.clear()
        extra = ["--branch", "smoke"] if cmd == "repo" else []
        rc = cli.main([cmd, *extra, "--scanners", "secret,license", "--license-full",
                       "--format", "json", "-o", str(out), "--device", "cuda", "-q", target])
        check(rc == 0, f"sources: {cmd} exited {rc}")
        repo_reports[cmd] = (json.loads(out.read_text()), dict(LAUNCHES))
    (repo_r, repo_launches), (fs_r, _) = repo_reports["repo"], repo_reports["fs"]
    result["repo"] = {
        "phase_s": time.perf_counter() - t0, "launches": repo_launches,
        "results": len(repo_r["Results"]),
        "results_equal_to_fs": renamed(repo_r, fs_r["ArtifactName"]) == fs_r["Results"],
    }

    # (e) vm: an ext4 disk of the fs-vuln tree and the trace phase's licenses
    t0 = time.perf_counter()
    tree_bytes = sum(f.stat().st_size for f in fs_tree.rglob("*") if f.is_file())
    disk = root / "disk.img"
    with open(disk, "wb") as f:
        f.truncate(((2 * tree_bytes) >> 20) + 64 << 20)
    subprocess.run(["mkfs.ext4", "-q", "-d", str(fs_tree), str(disk)], check=True)
    mkfs_s = time.perf_counter() - t0
    # the CPU reference in a child process beside the card's scan and rescan
    cpu_proc = cpu_cli(disk, root, "vm-cpu", "--license-full", "--db-repository", str(db_dir),
                       "--cache-dir", str(root / "cache-vm-cpu"),
                       scanners="vuln,secret,license", command="vm")
    vm = []
    for _ in range(2):
        LAUNCHES.clear()
        rep, st = cli.scan_vm(str(disk), device="cuda", cache_dir=str(root / "cache-vm"), **kw)
        vm.append((rep.to_dict(), st, dict(LAUNCHES)))
    (vm_r, vm_st, vm_launches), (re_r, re_st, re_launches) = vm
    cpu_r, cpu_st = cpu_cli_wait(cpu_proc, root, "vm-cpu")
    found_v = {(v["PkgName"], v["VulnerabilityID"], v["InstalledVersion"])
               for r in vm_r["Results"] for v in r.get("Vulnerabilities", [])}
    vm_missed = [p for p in plants() if (p[2], p[3], p[4]) not in found_v]
    vm_secrets = found(vm_r)
    vm_missed_secrets = [p for p in fs_secrets if ("/" + p[0], p[1], p[2]) not in vm_secrets]
    got_lic = licenses_found(vm_r)
    vm_missed_lic = [k for k in sorted(FULL_TEXTS)[:TRACE_LICENSE_FILES]
                     if k not in got_lic.get(f"licenses/{k}/LICENSE", ())]
    result["vm"] = {
        "disk_bytes": disk.stat().st_size, "tree_bytes": tree_bytes, "mkfs_s": mkfs_s,
        "seconds": vm_st["seconds"], "cpu_seconds": cpu_st["seconds"],
        "rescan_seconds": re_st["seconds"], "files_walked": vm_st["files_walked"],
        "components": vm_st["components"], "analyze_s": vm_st["analyze.seconds"],
        "detect_s": vm_st["detect.seconds"], "launches": vm_launches,
        "rescan_launches": re_launches, "rescan_files_walked": re_st["files_walked"],
        "cpu_equal": all(vm_r[k] == cpu_r[k] for k in ("Results", "Metadata")),
        "rescan_equal": re_r["Results"] == vm_r["Results"], "missed": vm_missed[:5],
        "secrets_missed": vm_missed_secrets, "licenses_missed": vm_missed_lic,
    }
    # (f) k8s: a cluster dump with its workload images scanned on the card
    result["k8s"] = sources_k8s(root, len(fs_secrets))
    result["launches_k8s"] = result["k8s"]["launches"]
    result["seconds"] = time.perf_counter() - t_phase
    log(result)
    r = result["registry"]
    check(r["results_equal_to_archive"],
          "sources: the registry scan's Results differ from the archive's")
    check(all(launches.get(k, 0) > 0 for k in IMAGE_KERNELS) and launches.get("verscmp") == 1,
          f"sources: a kernel was not launched by the registry scan: {launches}")
    check(r["cached"]["layers_analyzed"] == 0,
          f"sources: the registry scan on the archive's cache analyzed "
          f"{r['cached']['layers_analyzed']} layers")
    check(not any(launches_cached.get(k, 0) for k in IMAGE_KERNELS),
          f"sources: the cached registry scan launched a feed or license kernel: "
          f"{launches_cached}")
    d = result["daemon"]
    check(d["results_equal_to_cut"], "sources: the daemon scan's Results differ from the cut's")
    check(d["temp_archives_left"] == 0, "sources: the daemon export was not removed")
    check(all(d_launches.get(k, 0) > 0 for k in ("prefilter", "decompress")),
          f"sources: the daemon scan launched no feed kernel: {d_launches}")
    b = result["diff_base"]
    check((b["layers_seeded"], b["layers_analyzed"]) == (len(cut_layers), 1),
          f"sources: diff-base seeded {b['layers_seeded']}, analyzed {b['layers_analyzed']}")
    check(b["results_equal_to_plain"], "sources: diff-base Results differ from a plain scan")
    check(b["secret_reported"] and b["vuln_reported"], "sources: a diff-base plant was missed")
    check(all(diff_launches.get(k, 0) > 0 for k in ("prefilter", "decompress", "verscmp")),
          f"sources: the diff-base scan launched no feed kernel: {diff_launches}")
    check(result["repo"]["results_equal_to_fs"], "sources: repo Results differ from fs")
    check(all(repo_launches.get(k, 0) > 0 for k in ("prefilter", "decompress", "gram_gate")),
          f"sources: the repo scan launched no feed kernel: {repo_launches}")
    v = result["vm"]
    check(v["cpu_equal"], "sources: vm Results or Metadata differ between card and CPU")
    check(not v["missed"], f"sources: vm missed {len(vm_missed)} planted components")
    check(not v["secrets_missed"], f"sources: vm secrets missed: {vm_missed_secrets}")
    check(not v["licenses_missed"], f"sources: vm licenses missed: {vm_missed_lic}")
    check(all(vm_launches.get(k, 0) > 0 for k in (*IMAGE_KERNELS, "verscmp")),
          f"sources: a kernel was not launched by the vm scan: {vm_launches}")
    check(v["rescan_files_walked"] == 0 and v["rescan_equal"]
          and not any(re_launches.get(k, 0) for k in IMAGE_KERNELS),
          f"sources: the vm rescan was no cache hit: {re_launches}")
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--e2e-mib", type=int, default=48, help="size of the e2e tree")
    ap.add_argument("--license-mib", type=int, default=48, help="size of the license tree")
    ap.add_argument("--image-mib", type=int, default=32, help="layer bytes of the image")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    t0 = t_start = time.perf_counter()
    card = card_info()
    for name in ("scan_fs", "scan_image", "scan_vm", "scan_sbom", "scan_fleet"):
        setattr(cli, name, unfaulted(getattr(cli, name)))
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, together
        libs = dict(zip(LIBRARIES, pool.map(_build.build, LIBRARIES)))
    ptxas = {name: [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name in LIBRARIES}
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "libraries": {k: v.name for k, v in libs.items()}, "ptxas": ptxas, "card": card,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    rng = np.random.default_rng(args.seed)
    base = text_base(random.Random(args.seed), 1 << 20)
    base_np = np.frombuffer(base, dtype=np.uint8)
    compiled = compile_rules(SecretScanner().rules)
    custom = [
        (compile_rules(SecretScanner(ScannerConfig.from_dict(CUSTOM["config"](name))).rules),
         CUSTOM["RULESETS"][name][1], 64)
        for name in CHECK_RULESETS
    ]
    verdict = phase_check([(compiled, sorted(SAMPLES.values()), BATCH), *custom], base_np, rng)
    verdict["decompress"] = phase_check_decompress(base_np, rng)
    verdict.update(phase_check_license(base, base_np, args.seed))
    verdict["verscmp"] = phase_check_verscmp(rng)
    timing = phase_timing(compiled, base_np, rng, card)
    dec_timing = phase_timing_decompress(base_np, rng, card)
    lic_timing = phase_timing_license(base, base_np, args.seed, card)
    tmp = REPO / ".chip_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        e2e, planted = phase_e2e(tmp / "tree", args.e2e_mib, args.seed, base)
        phase_dedup(tmp, tmp / "tree", planted, args.seed, base)
        lic = phase_license(tmp / "license", args.license_mib, args.seed, base)
        feed = phase_feed(tmp / "feed", tmp / "tree", tmp / "license", card)
        shutil.rmtree(tmp / "feed", ignore_errors=True)
        shutil.rmtree(tmp / "license", ignore_errors=True)
        phase_license_repo(tmp / "repo")
        shutil.rmtree(tmp / "repo", ignore_errors=True)
        cve = phase_cve(tmp / "cve", args.seed, card)
        fs_vuln = phase_fs_vuln(tmp / "fs-vuln", tmp / "cve" / "db", args.seed, base, card)
        fs_secrets = fs_vuln.pop("secrets_planted")
        incremental = phase_incremental(tmp / "incremental", tmp / "fs-vuln" / "tree",
                                        fs_vuln.pop("db"), tmp / "cve" / "db",
                                        fs_vuln.pop("full_results"),
                                        fs_vuln.pop("full_launches"), card)
        shutil.rmtree(tmp / "incremental", ignore_errors=True)
        ladder = phase_ladder(tmp / "ladder", tmp / "fs-vuln" / "tree", tmp / "tree",
                              tmp / "cve", card)
        mesh = phase_mesh(tmp / "mesh", tmp / "tree", feed["cut_results"], base, args.seed, card)
        shutil.rmtree(tmp / "mesh", ignore_errors=True)
        shutil.rmtree(tmp / "tree", ignore_errors=True)
        shutil.rmtree(tmp / "ladder", ignore_errors=True)
        kernel_ms = {use: timing[use]["ms"] for use in ("prefilter", "anchored")}
        kernel_ms.update(decompress=dec_timing["text"]["ms"], verscmp=cve["timing"]["ms"],
                         gram_gate=lic_timing["gram_gate"]["ms"],
                         bytes_gate=lic_timing["bytes_gate_4096"]["ms"],
                         bytes_score=lic_timing["bytes_score_4096"]["ms"])
        phase_trace(tmp / "fs-vuln" / "tree", tmp / "cve" / "db", kernel_ms, card)
        formats = phase_formats(tmp / "formats", tmp / "fs-vuln" / "tree", tmp / "cve" / "db",
                                card)
        shutil.rmtree(tmp / "formats", ignore_errors=True)
        misconf = phase_misconf(tmp / "misconf", args.seed, base, card)
        shutil.rmtree(tmp / "misconf", ignore_errors=True)
        server = phase_server(tmp / "server", tmp / "fs-vuln" / "tree", tmp / "cve" / "db",
                              card)
        shutil.rmtree(tmp / "server", ignore_errors=True)
        image, first_image, cut_image = phase_image(tmp / "image", tmp / "cve" / "db", args.seed,
                                                    base, args.image_mib, card)
        (tmp / "sources").mkdir()
        sources = phase_sources(tmp / "sources", tmp / "image", tmp / "fs-vuln" / "tree",
                                tmp / "cve" / "db", fs_secrets, first_image, cut_image, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [
        {
            "name": f"match_kernel ({use})", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "launches": e2e["launches"].get(use, 0),
            "max_abs_err": verdict[use]["max_abs_err"], "equal": verdict[use]["equal"],
            "ms": timing[use]["ms"], "plain_ms": timing[use]["plain_ms"],
            "bound_ms": timing[use]["bound_ms"], "bound_by": timing[use]["bound_by"],
            "library_ms": None,
            "ms_source": timing[use]["ms_source"], "ms_random": timing[use]["ms_random"],
            "ms_dense": timing[use]["ms_dense"],
        }
        for use in ("prefilter", "anchored")
    ]
    text, source, mix = dec_timing["text"], dec_timing["source"], dec_timing["mix"]
    kernels.append({
        "name": "decompress_kernel", "route": "cuda", "source": DECOMPRESS_SOURCE,
        "replaces": DECOMPRESS_REPLACES, "launches": e2e["launches"].get("decompress", 0),
        "max_abs_err": verdict["decompress"]["max_abs_err"],
        "equal": verdict["decompress"]["equal"],
        "ms": text["ms"], "plain_ms": text["plain_ms"], "bound_ms": text["bound_ms"],
        "bound_by": text["bound_by"], "library_ms": None,
        "ms_source": source["ms"], "bound_ms_source": source["bound_ms"],
        "ms_mix": mix["ms"], "bound_ms_mix": mix["bound_ms"],
        "launches_per_call": text["launches_per_call"]["by_type"].get("kernel"),
    })
    # the license kernels: times at the gram gate's seeded batch and at the
    # 4096 rung, the other inputs, rungs and gathered batches beside them,
    # with the launches on the main path by [rows, width]
    # (the scorer's agreement is within SCORE_RTOL, the others' bitwise)
    for name, (src, replaces) in LICENSE_KERNELS.items():
        t = lic_timing[name if name == "gram_gate" else f"{name}_4096"]
        entry = {
            "name": f"{name}_kernel", "route": "cuda", "source": src, "replaces": replaces,
            "launches": lic["launches"].get(name, 0), "max_abs_err": verdict[name]["max_abs_err"],
            **{k: verdict[name][k] for k in ("equal", "within_tol", "rtol") if k in verdict[name]},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"],
        }
        if name == "gram_gate":
            lt = lic_timing["gram_gate_license"]
            entry.update(ms_license=lt["ms"], screen_pass_share=t["screen_pass_share"],
                         screen_pass_share_license=lt["screen_pass_share"])
        else:
            for key, res in lic_timing.items():
                if key.startswith(f"{name}_") and key != f"{name}_4096":
                    tag = key[len(name) + 1 :]
                    entry[f"ms_{tag}"] = res["ms"]
                    entry[f"bound_ms_{tag}"] = res["bound_ms"]
            entry["launches_by_shape"] = lic["launches_by_shape"][name]
        if name == "bytes_gate":
            entry["launches_per_call"] = t["launches_per_call"]["by_type"].get("kernel")
        kernels.append(entry)
    t = cve["timing"]
    kernels.append({
        "name": "verscmp_kernel", "route": "cuda", "source": VERSCMP_SOURCE,
        "replaces": VERSCMP_REPLACES, "launches": cve["scans"][0]["launches"].get("verscmp", 0),
        "launches_fs_vuln": fs_vuln["scans"][0]["launches"].get("verscmp", 0),
        "max_abs_err": verdict["verscmp"]["max_abs_err"],
        "equal": verdict["verscmp"]["equal"] and t["equal"] and fs_vuln["kernel_equal"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "shape": t["shape"], "ms_cold": t["ms_cold"],
        "ms_distinct": t["distinct"]["ms"], "ms_distinct_cold": t["distinct"]["ms_cold"],
        "bound_ms_distinct": t["distinct"]["bound_ms"], "plan": t["plan"],
        "dispatch_ms": t["dispatch"]["new"]["dispatch_ms"],
        "dispatch_ms_old_route": t["dispatch"]["old"]["dispatch_ms"],
    })
    # each kernel's launches in the formats phase's card scans, in the image
    # phase's first scan, in the sources phase's registry scan, in the ladder
    # phase and in the server phase's client/server scan
    for entry, key in zip(kernels, (*IMAGE_KERNELS, "verscmp"), strict=True):
        entry["launches_formats"] = formats["launches"].get(key, 0)
        # phase misconf's leg (a): fs --scanners misconfig,secret,license;
        # leg (f): fs --scanners misconfig,secret of the Terraform monorepo
        entry["launches_misconf"] = misconf["launches"].get(key, 0)
        entry["launches_misconf_terraform"] = misconf["f"]["launches"].get(key, 0)
        # leg (c): fs --scanners misconfig,secret of the CloudFormation and
        # Helm tree (the feed's kernels only)
        entry["launches_misconf_iac"] = misconf["c"]["launches"].get(key, 0)
        entry["launches_image"] = image["launches"].get(key, 0)
        entry["launches_registry"] = sources["launches_registry"].get(key, 0)
        # phase sources' leg (f): k8s --scan-images of the dump's images
        entry["launches_k8s"] = sources["launches_k8s"].get(key, 0)
        entry["launches_ladder"] = ladder["launches"].get(key, 0)
        # phase incremental: the cold scan, and every scan of an unchanged
        # tree after it (the rescans, the diff-base scan, the watch)
        entry["launches_incremental"] = incremental["steps"][0]["launches"].get(key, 0)
        entry["launches_incremental_rescans"] = incremental["watch_launches"].get(key, 0) + sum(
            st["launches"].get(key, 0) for st in incremental["steps"]
            if st["step"] in ("unchanged", "diff-base"))
        # phase server's client/server scan: the client's feed and license
        # kernels and the in-process server's constraint kernel
        entry["launches_server"] = server["launches"].get(key, 0)
        # phase server's leg (g): each sub-leg's launches by the replicas'
        # shard scans, the coordinator's fold and its local fallback
        entry["launches_fleet"] = {
            f"{leg}_{role}": server["fleet"][leg]["launches"][role].get(key, 0)
            for leg in ("g1", "g2", "g3", "g4", "g5")
            for role in ("replicas", "fold", "fallback")}
        # phase mesh's round-robin and data = 2 mesh runs over [cuda:0, cuda:0]
        for tag, run in (("round_robin", "round-robin"), ("mesh", "mesh")):
            entry[f"launches_{tag}"] = mesh["runs"][run]["launches"].get(key, 0)
            entry[f"batches_by_index_{tag}"] = mesh["runs"][run]["batches_by_index"]
    score = next(e for e in kernels if e["name"] == "bytes_score_kernel")
    for tag, res in mesh["bytes_score"].items():  # the scorer at the shard widths
        score[f"ms_shard_{tag}"] = res["ms"]
        score[f"bound_ms_shard_{tag}"] = res["bound_ms"]
        score[f"max_abs_err_shard_{tag}"] = res["max_abs_err"]
    log({"phase": "done", "seconds": time.perf_counter() - t_start,
         "unfaulted_scans_checked": UNFAULTED["scans"]})
    log({"kernels": kernels})
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
