"""Shared build-on-first-import logic for the native C++ components.

Staleness is keyed on a CONTENT HASH of the source plus a FINGERPRINT of
the host CPU, recorded in a sidecar file next to the binary — not on
mtimes: git does not preserve mtimes, and the libraries are built with
``-march=native``, so a ``.so`` copied along with a checkout to another
machine could use instructions that machine lacks (SIGILL).  The binaries
are excluded from version control; a library is only ever loaded when the
sidecar proves it was built from exactly the source present, on a CPU with
the same model and feature flags.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess


def _src_hash(src: str) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def host_fingerprint() -> str:
    """Digest of what ``-march=native`` compiles for: the machine type,
    the CPU model and its feature flags (first processor in
    /proc/cpuinfo; the platform's processor string elsewhere)."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    parts.append(line.strip())
                elif not line.strip() and len(parts) > 1:
                    break  # end of the first processor's block
    except OSError:
        parts.append(platform.processor())
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


def build_key(src: str) -> str:
    """Sidecar content: source hash + host-CPU fingerprint."""
    return f"{_src_hash(src)}:{host_fingerprint()}"


def ensure_built(src: str, so: str, extra_flags: tuple = ()) -> bool:
    """(Re)build ``so`` from ``src`` unless the sidecar key matches the
    current source and host CPU.  Returns True when a trusted binary
    exists."""
    tag = so + ".srchash"
    key = build_key(src)
    if os.path.exists(so) and os.path.exists(tag):
        try:
            with open(tag) as f:
                if f.read().strip() == key:
                    return True
        except OSError:
            pass
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", so, src,
             *extra_flags],
            check=True, capture_output=True, timeout=120,
        )
    except Exception:
        return False
    with open(tag, "w") as f:
        f.write(key)
    return True
