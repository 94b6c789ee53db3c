"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled on first use by ``nvcc`` into its
own shared library with a plain C interface, loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. Libraries go into ``build/``
next to this file (ignored by git), named by a hash of their source and
of the headers under ``csrc/``, so an edited source or header is rebuilt
and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD = _HERE / "build"

SOURCES = ("moe_ffn", "topk_router")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on a machine with the "
        "CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


def _lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source,
    of every header under ``csrc/`` (any of them may be included) and of
    the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for ``name`` unless its library is built already."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc


def _finish(name: str, started) -> str | None:
    """Wait for one nvcc; install its library, or return its error log."""
    out, tmp, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed for {name}.cu:\n{log}"
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return None


def build_all(names=SOURCES) -> None:
    """Compile every named source that is not built yet, in parallel."""
    started = {n: _start(n) for n in names}
    errors = [_finish(n, s) for n, s in started.items() if s is not None]
    errors = [e for e in errors if e]
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    lib = _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
