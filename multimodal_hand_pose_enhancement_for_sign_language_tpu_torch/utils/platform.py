"""Host and toolchain fingerprints for the port's build cache.

Counterpart of the JAX package's ``utils/platform.py``, which only steers
JAX: ``ensure_platform_from_env`` makes ``JAX_PLATFORMS`` win over a
platform set at interpreter start, and ``enable_persistent_compile_cache``
keys XLA's compile cache by ``host_fingerprint``.  Neither has a
counterpart here: the port picks its device per call (``utils/device``; an
entry point runs on CUDA unless the caller passes ``device="cpu"``, and
reads no environment variable for it), and its only compiled artifacts are
``ops/build``'s kernel libraries, whose cache key holds
``toolchain_fingerprint`` beside the source and the flags, so that a
library built by another ``nvcc`` or host compiler is never loaded.
"""

from __future__ import annotations

import functools
import hashlib
import platform as plat
import subprocess


def host_fingerprint() -> str:
    """Short hash of the host CPU's identity and feature set: the JAX
    package's function, which gives the same string on the same host."""
    txt = plat.machine()
    # flags alone are not enough: two host generations with identical
    # cpuinfo flags can differ in model-specific tuning, so the CPU's model
    # identity is part of it too
    wanted = ("flags", "Features", "cpu family", "model", "stepping")
    try:
        seen = set()
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key.startswith(wanted) and key not in seen:
                    seen.add(key)
                    txt += line
    except OSError:
        pass
    return hashlib.sha1(txt.encode()).hexdigest()[:10]


def _first_line(cmd) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    out = (proc.stdout or proc.stderr).strip().splitlines()
    return f"{out[0] if out else ''} (exit {proc.returncode})"


@functools.lru_cache(maxsize=None)
def toolchain_fingerprint(nvcc: str, host: str) -> str:
    """The text that identifies a CUDA toolchain: ``nvcc --version`` as
    ``nvcc`` prints it, and the first line of ``--version`` of the host
    compiler ``host``, which ``ops/build`` names to ``nvcc`` by ``-ccbin``.
    Read once per process and pair of paths."""
    try:
        proc = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
        version = f"{proc.stdout.strip()} (exit {proc.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        version = f"{nvcc}: {e}"
    return f"{version}\nhost compiler {host}: {_first_line([host, '--version'])}"
