"""ctypes bindings of the port's host C++ (``native/``), as in the JAX
package's ``runtime/native.py``: ``AsyncCheckpointWriter`` over
``native/ckpt_writer.cpp`` (the checkpoint layer's ``native`` backend)
and ``Watchdog`` over ``native/watchdog.cpp`` (the supervisor's hang
evidence).

Both sources are host C++ with a plain C interface, not kernels. They
are built together at first use with ``g++ -O3 -fPIC -std=c++17 -pthread
-shared`` into ``build/torch_kernels/dlcs_host-<hash>.so`` at the root of
the checkout, ``<hash>`` covering the sources and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. A failed build
raises with the compiler's output; there is no Python fallback. Nothing
is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_LIB = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cpp")))


def _target() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"dlcs_host-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Build the host library unless it is built; returns its path."""
    target = _target()
    if os.path.exists(target):
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *_sources()],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed to build the host library from "
                           f"native/*.cpp (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, target)     # atomic: concurrent builds agree
    return target


def lib() -> ctypes.CDLL:
    """The host library, built on first use."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        h = ctypes.CDLL(build())
        h.dlcs_watchdog_create.restype = ctypes.c_void_p
        h.dlcs_watchdog_create.argtypes = [ctypes.c_int]
        h.dlcs_watchdog_kick.argtypes = [ctypes.c_void_p]
        h.dlcs_watchdog_expired.restype = ctypes.c_int
        h.dlcs_watchdog_expired.argtypes = [ctypes.c_void_p]
        h.dlcs_watchdog_destroy.argtypes = [ctypes.c_void_p]
        h.dlcs_ckpt_writer_create.restype = ctypes.c_void_p
        h.dlcs_ckpt_writer_create.argtypes = [ctypes.c_int]
        h.dlcs_ckpt_writer_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        for f in ("dlcs_ckpt_writer_pending", "dlcs_ckpt_writer_errors"):
            getattr(h, f).restype = ctypes.c_int
            getattr(h, f).argtypes = [ctypes.c_void_p]
        h.dlcs_ckpt_writer_wait.argtypes = [ctypes.c_void_p]
        h.dlcs_ckpt_writer_destroy.argtypes = [ctypes.c_void_p]
        _LIB = h
        return h


class Watchdog:
    """Native hang detector: a monitor thread (immune to a GIL held by hung
    Python) latches ``expired`` if ``kick()`` isn't called within
    ``timeout_ms``. Check the latch *before* kicking: ``kick()`` clears
    it."""

    def __init__(self, timeout_ms: int):
        self._h = lib().dlcs_watchdog_create(timeout_ms)
        if not self._h:
            raise RuntimeError("watchdog thread creation failed")

    def kick(self) -> None:
        lib().dlcs_watchdog_kick(self._h)

    @property
    def expired(self) -> bool:
        return bool(lib().dlcs_watchdog_expired(self._h))

    def close(self) -> None:
        if self._h:
            lib().dlcs_watchdog_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AsyncCheckpointWriter:
    """Background checkpoint writes through the native worker pool
    (``native/ckpt_writer.cpp``): ``submit`` copies the buffers and
    returns at once, so training on the next segment overlaps the disk
    write, and the staged directory is renamed to ``final_dir`` when it is
    complete (the checkpoint layer's publish protocol, done natively)."""

    def __init__(self, n_threads: int = 2):
        self._h = lib().dlcs_ckpt_writer_create(n_threads)

    def submit(self, tmp_dir: str, final_dir: str, names, arrays) -> None:
        """Queue one checkpoint: write each ``arrays[i]`` (host numpy) to
        ``<tmp_dir>/<names[i]>.raw``, then rename to ``final_dir``. The
        buffers are copied before this returns."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        n = len(arrays)
        c_names = (ctypes.c_char_p * n)(*[name.encode() for name in names])
        c_ptrs = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
        c_sizes = (ctypes.c_int64 * n)(*[a.nbytes for a in arrays])
        lib().dlcs_ckpt_writer_submit(self._h, tmp_dir.encode(),
                                      final_dir.encode(), c_names, c_ptrs,
                                      c_sizes, n)

    def pending(self) -> int:
        return lib().dlcs_ckpt_writer_pending(self._h)

    def wait(self) -> None:
        """Block until every submitted checkpoint is published."""
        lib().dlcs_ckpt_writer_wait(self._h)

    def errors(self) -> int:
        """Failed jobs so far (their tmp dirs are left for inspection)."""
        return lib().dlcs_ckpt_writer_errors(self._h)

    def close(self) -> None:
        if self._h is not None:
            lib().dlcs_ckpt_writer_destroy(self._h)  # drains first
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
