"""The port's CUDA sources built with ``nvcc`` into shared libraries with a
plain C interface, which the kernels' wrappers load with ``ctypes``."""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    import shutil

    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


def build(source: Path, depends: Sequence[Path] = ()) -> Path:
    """Compile ``source`` for sm_90a into ``BUILD_DIR`` if this source, and
    the files it includes that ``depends`` lists, have not been built yet.
    The file name carries a hash of them; a file lock keeps concurrent
    processes from building the same library twice, and the result is
    moved into place atomically; nvcc's and ptxas's output goes to
    ``<library>.log`` beside it. Returns the library path."""
    import fcntl
    import subprocess

    digest = hashlib.sha256()
    for path in (source, *depends):
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / f"{lib.stem}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib
