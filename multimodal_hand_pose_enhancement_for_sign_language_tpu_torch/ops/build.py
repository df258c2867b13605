"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<digest>.so`` at the repository root (the digest
covers the source and the flags, so an edited source rebuilds), with
``ptxas``'s register and spill report kept beside it as ``<lib>.ptxas``,
and loaded with ``ctypes``; ``bind`` sets a C entry's argument types once,
and ``launch`` calls it on PyTorch's current stream.  ``sass`` lists a built
library's machine code, and ``loop_fp32_per_cycle`` counts the FP32
instructions of a kernel's loop in that listing.
Nothing here runs at import time: this module imports on machines that
have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}
# name -> {"seconds": float, or None when the library was already built,
# "ptxas": the ptxas report of its build}
build_log: dict = {}


def _tool(name: str) -> str:
    for cand in (
        shutil.which(name),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA toolkit")


def library(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(names) -> None:
    """Compile every source of ``names`` whose library or ptxas report is
    missing, one nvcc each, all started together; fill ``build_log``."""
    running = {}
    for name in names:
        out = library(name)
        report = Path(f"{out}.ptxas")
        if out.exists() and report.exists():
            build_log.setdefault(name, {"seconds": None, "ptxas": report.read_text()})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, tmp, out, report, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, report, t0) in running.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
            continue
        report.write_text(text)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": text}
    if failed:
        raise RuntimeError("\n".join(failed))


def build(*names: str) -> None:
    """Build the libraries of ``names`` side by side (see ``_compile``)."""
    with _lock:
        _compile(names)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _libs:
            _compile((name,))
            _libs[name] = ctypes.CDLL(str(library(name)))
        return _libs[name]


def bind(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its argument types
    and its ``int`` result (a cudaError_t) set once, at first use."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def launch(fn, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` with PyTorch's current stream on ``device``;
    raises if the C entry returns a CUDA error."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: cudaError {rc}")


_INSTR = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_PRED = re.compile(r"^@!?U?P\w+\s+")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")
_FP32 = re.compile(r"^(FADD|FMUL|FFMA)(32I)?(\.|$)")


def loop_fp32_per_cycle(sass: str, function: str, marker: str,
                        per_cycle: int) -> float:
    """FP32 instructions (FADD, FMUL, FFMA) per cycle of the loop of
    ``function`` in a ``cuobjdump -sass`` listing.  The loop is the
    smallest span from a backward branch's target to the branch that holds
    the instruction ``marker``, which a cycle issues ``per_cycle`` times;
    so a loop unrolled over several cycles is counted per cycle all the
    same."""
    body = None
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if function in part.split("\n", 1)[0]:
            body = part
            break
    if body is None:
        raise ValueError(f"no function matching {function!r} in the listing")
    instrs, labels, pending = [], {}, []
    for line in body.splitlines():
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.match(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            instrs.append((addr, _PRED.sub("", m.group(2))))
    best = None
    for addr, text in instrs:
        if not text.startswith("BRA"):
            continue
        t = _TARGET.search(text)
        if t is None:
            continue
        target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        if target is None or target > addr:
            continue
        span = [s for a, s in instrs if target <= a <= addr]
        marks = sum(s.split()[0] == marker for s in span)
        if marks and (best is None or len(span) < len(best[0])):
            best = (span, marks)
    if best is None:
        raise ValueError(f"no loop of {function!r} holds {marker}")
    span, marks = best
    fp32 = sum(bool(_FP32.match(s.split()[0])) for s in span)
    return fp32 * per_cycle / marks


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library of ``csrc/<name>.cu``."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(library(name))],
                         capture_output=True, text=True, check=True, timeout=120)
    return out.stdout
