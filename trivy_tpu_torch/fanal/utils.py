"""Content sniffing helpers (ref: pkg/fanal/utils/utils.go), the port of
``trivy_tpu/fanal/utils.py``: the secret analyzer's binary sniff and
strings extraction, and the Go and Rust binary analyzers' sniff."""

from __future__ import annotations

# Control bytes that mark content as binary when found in the head
# (ref: pkg/fanal/utils/utils.go:85-100 — a 300-byte sniff).
_SNIFF_LEN = 300
_PRINTABLE_MIN = 7  # below \a => control
_MIN_PRINTABLE_RUN = 4


def is_binary(head: bytes) -> bool:
    """True when any of the first 300 bytes is a control byte."""
    for b in head[:_SNIFF_LEN]:
        if b < _PRINTABLE_MIN or (13 < b < 27) or (27 < b < 32) or b == 127:
            return True
    return False


def extract_printable_bytes(data: bytes) -> bytes:
    """strings(1)-like extraction of printable runs from binary content
    (ref: pkg/fanal/utils/utils.go:128+): runs of >=4 printable characters,
    newline-joined."""
    out = bytearray()
    run = bytearray()
    for b in data:
        if 32 <= b < 127 or b == 9:
            run.append(b)
        else:
            if len(run) >= _MIN_PRINTABLE_RUN:
                out += run
                out += b"\n"
            run.clear()
    if len(run) >= _MIN_PRINTABLE_RUN:
        out += run
        out += b"\n"
    return bytes(out)
