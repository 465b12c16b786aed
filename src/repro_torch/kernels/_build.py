"""Build of the port's CUDA C++ kernels.

Every kernel source is ``kernels/<package>/csrc/*.cu``.  Each compiles
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, at first use, into ``build/`` beside this file (a gitignored
directory), and is loaded through ``ctypes``.  A library's file name
carries a hash of its source and of the flags, so an edited source builds
anew.  Nothing is compiled or loaded at import time: the kernel modules
import on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}


def sources() -> Tuple[Path, ...]:
    """Every kernel source of the port, in a fixed order."""
    return tuple(sorted(KERNELS_DIR.glob("*/csrc/*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return path


def _lib_path(source: Path) -> Path:
    tag = hashlib.sha1(source.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build_all(srcs: Optional[Iterable[Path]] = None
              ) -> Dict[Path, Tuple[Path, str]]:
    """Compile each source's library (once per source version), one
    ``nvcc`` per source, all started together; ``srcs`` defaults to every
    kernel source of the port.  Returns ``source -> (library path,
    compiler output)``; the output (``-Xptxas -v``: registers, shared
    memory, spills) is empty for a library already built.  Raises if any
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done, running = {}, {}
    try:
        for src in (sources() if srcs is None else srcs):
            lib = _lib_path(src)
            if lib.exists():
                done[src] = (lib, "")
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[src] = (proc, tmp, lib)
        failed = []
        for src, (proc, tmp, lib) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} ({proc.returncode}):"
                              f"\n{log}")
                continue
            os.replace(tmp, lib)
            done[src] = (lib, log)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return done


def load(source: Path) -> ctypes.CDLL:
    """The source's library, built if needed, loaded once per process."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(str(build_all((source,))[source][0]))
    return _LOADED[source]


def on_cuda(t, kernel: str) -> bool:
    """The dispatch rule of every ``ops`` entry point: a CUDA tensor goes
    to the kernel (which launches or raises), a CPU tensor to the plain
    version; any other device raises."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {kernel} kernel for device {t.device}")
    return t.device.type == "cuda"


def launched(err: int, name: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")
