"""Build and load the hand-written CUDA kernels (``*/csrc/*.cu``).

Each source has a plain C interface.  At first use it is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the root of the checkout, named by the hash of
its source so an edited source rebuilds, and loaded with ``ctypes``.
Nothing is fetched or cached outside the checkout.  A failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel source name -> path of its .cu file
SOURCES = {
    "am_pack": _PKG / "am_pack" / "csrc" / "am_pack.cu",
    "am_pack_sm90": _PKG / "am_pack" / "csrc" / "am_pack_sm90.cu",
    "jacobi": _PKG / "jacobi" / "csrc" / "jacobi.cu",
    "gascore_dma": _PKG / "gascore_dma" / "csrc" / "gascore_dma.cu",
    "gascore_dma_sm90": _PKG / "gascore_dma" / "csrc" / "gascore_dma_sm90.cu",
    "flash": _PKG / "attention" / "csrc" / "flash.cu",
    "flash_sm90": _PKG / "attention" / "csrc" / "flash_sm90.cu",
    "flash_sm90_f32": _PKG / "attention" / "csrc" / "flash_sm90_f32.cu",
    "flash_sm90_bwd": _PKG / "attention" / "csrc" / "flash_sm90_bwd.cu",
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler (``$PATH`` first, then the toolkit's
    default location); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are compiled at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library exists; returns
    ``(process or None, temporary output, final output)``."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)        # atomic: concurrent builders agree
    return log


def build_all(names=None) -> dict[str, str]:
    """Compile every kernel source at once (one ``nvcc`` per source, all
    started together).  Returns each source's compiler log (register
    and spill counts from ``ptxas -v``; empty when already built)."""
    names = list(SOURCES if names is None else names)
    started = {n: _start(n) for n in names}
    logs, failures = {}, []
    for n, job in started.items():     # wait for every compiler first
        try:
            logs[n] = _finish(n, *job)
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
