"""Build the CUDA sources with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout
(listed in ``.gitignore``).  The hash covers the source, every header in
``csrc/`` (the sources share ``pdes_common.cuh``) and the flags, so a
changed source or header rebuilds and an unchanged one loads the library
already built.  A build failure raises with the compiler's output; the
compiler's log (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library.

The launch helpers at the end are shared by the kernel wrappers;
:func:`ptxas_info` reads a built library's log (the linter's
``vmem-budget`` rule and ``chip_smoke.py`` phase 16).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build on a machine with the CUDA toolkit")
    return str(path)


def library_path(name: str) -> pathlib.Path:
    """Where the shared library of ``csrc/<name>.cu`` is (to be) built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is built; return its path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(text: str) -> dict:
    """``{entry function: {"registers", "static_smem", "stack",
    "spill_stores", "spill_loads"}}`` from ``nvcc -Xptxas -v`` output."""
    out, entry = {}, None
    for line in text.splitlines():
        m = _ENTRY.search(line) or _PROPS.search(line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {"registers": 0, "static_smem": 0,
                                   "stack": 0, "spill_stores": 0,
                                   "spill_loads": 0})
            continue
        if entry is None:
            continue
        m = _SPILL.search(line)
        if m:
            out[entry].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            sm = _SMEM.search(line)
            out[entry]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def ptxas_info(name: str, kernel: str) -> dict | None:
    """The ptxas figures of ``kernel`` (the ``__global__`` function's name)
    in the log kept beside ``csrc/<name>.cu``'s library, the largest over
    its instantiations; None where it was not built here (no log)."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return None
    rows = [v for k, v in parse_ptxas(log.read_text()).items()
            if kernel in k]
    if not rows:
        return None
    return {k: max(r[k] for r in rows) for k in rows[0]}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(str(build(name)))


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream(dev: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``dev``, as the kernels' stream argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """Integers wrapped mod 2**32, flattened, as the kernels' uint32 bits."""
    t = x.to(torch.int64).reshape(-1) & 0xFFFFFFFF
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)
