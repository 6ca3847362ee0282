"""Build, load and count the port's hand-written CUDA kernels.

Every source under ``csrc/`` has a plain C interface and is compiled on
its own by ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch_kernels/<hash>/lib<name>.so``, the hash taken over
the source, the ``csrc/*.cuh`` headers it includes and the flags (with
the compiler's output beside it, ``lib<name>.log``), then loaded with
``ctypes``.  :func:`build_all` starts one ``nvcc`` per
source at once, so a fresh checkout pays for the slowest build only.

The launch-count registry lives here too: each wrapper adds one to
``launch_counts[<kernel name>]`` where it launches its kernel, and
nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch
from typing import Callable

__all__ = ["CudaLibrary", "build_all", "launch_counts",
           "reset_launch_counts", "counted", "cuda_stream",
           "refuse_grad"]

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


def cuda_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, as an int, read
    without building a ``torch.cuda.Stream`` object at every launch."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def counted(name: str) -> None:
    # depth-2 windows launch from their background delivery thread
    with _COUNT_LOCK:
        launch_counts[name] += 1


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a kernel that has no backward
    yet: its output, written through ``ctypes``, carries no
    ``grad_fn``, so the gradient of everything before it would be cut
    without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel yet (ROADMAP.md queue 1, the "
            "training slices): call it under torch.no_grad() or on "
            "tensors that do not require grad")


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
        #: the compiler's output (ptxas register, spill and shared-memory
        #: lines), kept beside the library and read back when it is cached
        self.build_log = ""
        with _COUNT_LOCK:
            for k in self.kernels:
                launch_counts.setdefault(k, 0)

    @property
    def source(self) -> str:
        """The CUDA source, relative to the repository root."""
        return str(self.src.relative_to(_ROOT))

    def headers(self) -> list[Path]:
        """The ``csrc/*.cuh`` headers the source includes."""
        names = re.findall(r'^\s*#include\s+"([^"]+\.cuh)"',
                           self.src.read_text(), flags=re.M)
        return [CSRC / n for n in names]

    def _target(self) -> Path:
        text = self.src.read_bytes() + b"".join(
            h.read_bytes() for h in self.headers())
        key = hashlib.sha256(text + " ".join(_FLAGS).encode()) \
            .hexdigest()[:16]
        return _BUILD_ROOT / key / f"lib{self.name}.so"

    def _start(self):
        """Start ``nvcc`` for this source (None when already built)."""
        lib = self._target()
        if lib.exists() and lib.with_suffix(".log").exists():
            return None
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"lib{self.name}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([_nvcc(), *_FLAGS, "-o", str(tmp),
                                 str(self.src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return proc, tmp, lib

    def _finish(self, started) -> Path:
        if started is None:
            lib = self._target()
            self.build_log = lib.with_suffix(".log").read_text()
            return lib
        proc, tmp, lib = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src}:\n{err}")
        self.build_log = err
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(err)
        os.replace(tmp, lib)
        os.replace(tmp_log, lib.with_suffix(".log"))
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
