"""Native (C++) host runtime: the threaded WAV ingest.

``_wavio`` (``wavio.cpp``, the JAX package's source under this package's
module name) decodes RIFF/WAV and assembles crop batches on a thread pool
with the GIL released: ``decode_wav(bytes)`` and ``load_crop_batch(paths,
crop_len, seed, num_threads=0)``, which crops file i at the offset
``std::mt19937_64(seed * 0x9E3779B97F4A7C15 + i)`` draws, so that a seed gives
the JAX package's batches.

It is built at first use with ``g++`` from the source in this checkout into
``build/native/`` beside the package (ignored by git), under a name that
carries a hash of the source, the Python version and numpy's, so a change
of any rebuilds it. Each build writes a temporary file and moves it into
place in one step, so processes that build at once leave one whole
library. Without a compiler :func:`get_wavio` warns and returns None, and
the callers take the Python path.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_SRC_PATH = Path(__file__).resolve().parent / "wavio.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_MODULE = "waveverify_torch.native._wavio"

_wavio = None
_build_attempted = False


def library_path() -> Path:
    """Where the extension for this source, Python and numpy lives."""
    import numpy as np

    h = hashlib.sha256(_SRC_PATH.read_bytes())
    h.update(f"{sys.version}|{np.__version__}".encode())
    return _BUILD_DIR / f"_wavio_{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile ``wavio.cpp`` (one ``g++`` call, a few seconds) unless its
    library exists; None, with a warning, if the compiler fails."""
    import numpy as np

    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
           str(_SRC_PATH), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        logger.warning("native _wavio build failed (%s); using the "
                       "pure-Python ingest path", detail.strip()[:500])
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def get_wavio():
    """The ``_wavio`` module, built on first use; None if it cannot be
    built (callers fall back to Python I/O)."""
    global _wavio, _build_attempted
    if _wavio is not None or _build_attempted:
        return _wavio
    _build_attempted = True
    lib = build()
    if lib is None:
        return None
    spec = importlib.util.spec_from_file_location(_MODULE, lib)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except ImportError as e:
        logger.warning("loading native _wavio failed (%s); using the "
                       "pure-Python ingest path", e)
        return None
    _wavio = mod
    return _wavio
