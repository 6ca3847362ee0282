"""Build, load and count the port's hand-written CUDA kernels.

Every source under ``csrc/`` has a plain C interface and is compiled on
its own by ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch_kernels/<hash of source and flags>/lib<name>.so``,
then loaded with ``ctypes``.  :func:`build_all` starts one ``nvcc`` per
source at once, so a fresh checkout pays for the slowest build only.

The launch-count registry lives here too: each wrapper adds one to
``launch_counts[<kernel name>]`` where it launches its kernel, and
nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

__all__ = ["CudaLibrary", "build_all", "launch_counts",
           "reset_launch_counts", "counted"]

CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[3]
_BUILD_ROOT = _ROOT / "build" / "repro_torch_kernels"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------
_COUNT_LOCK = threading.Lock()
launch_counts: dict[str, int] = {}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in launch_counts:
            launch_counts[name] = 0


def counted(name: str) -> None:
    # depth-2 windows launch from their background delivery thread
    with _COUNT_LOCK:
        launch_counts[name] += 1


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from csrc/*.cu at first use and need the CUDA "
                           "toolkit")
    return found


class CudaLibrary:
    """One ``csrc/<source>`` compiled into ``lib<name>.so``.

    ``bind(lib)`` sets the ``argtypes``/``restype`` of its entry points
    (``ctypes.c_void_p`` for pointers and the stream, or ctypes passes
    them as 32-bit ints).  ``kernels`` names the kernels it holds, each
    with the TPU kernel (file:line) it replaces; they join the
    launch-count registry."""

    def __init__(self, source: str, name: str,
                 bind: Callable[[ctypes.CDLL], None],
                 kernels: dict[str, str]):
        self.src = CSRC / source
        self.name = name
        self._bind = bind
        self.kernels = dict(kernels)
        self._lib = None
        self._lock = threading.Lock()
        #: the compiler's output of the build this process ran (ptxas
        #: register and shared-memory lines), empty when it was cached
        self.build_log = ""
        with _COUNT_LOCK:
            for k in self.kernels:
                launch_counts.setdefault(k, 0)

    @property
    def source(self) -> str:
        """The CUDA source, relative to the repository root."""
        return str(self.src.relative_to(_ROOT))

    def _target(self) -> Path:
        key = hashlib.sha256(self.src.read_bytes()
                             + " ".join(_FLAGS).encode()).hexdigest()[:16]
        return _BUILD_ROOT / key / f"lib{self.name}.so"

    def _start(self):
        """Start ``nvcc`` for this source (None when already built)."""
        lib = self._target()
        if lib.exists():
            return None
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"lib{self.name}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([_nvcc(), *_FLAGS, "-o", str(tmp),
                                 str(self.src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return proc, tmp, lib

    def _finish(self, started) -> Path:
        if started is None:
            return self._target()
        proc, tmp, lib = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src}:\n{err}")
        self.build_log = err
        os.replace(tmp, lib)
        return lib

    def build(self) -> Path:
        """Compile the source (once per source and flags) and return the
        shared library's path."""
        return self._finish(self._start())

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(self.build()))
                    self._bind(lib)
                    self._lib = lib
        return self._lib


def build_all(libraries) -> list[Path]:
    """Build every library with one ``nvcc`` each, all started together;
    returns the shared libraries' paths."""
    started = [(lib, lib._start()) for lib in libraries]
    return [lib._finish(s) for lib, s in started]
