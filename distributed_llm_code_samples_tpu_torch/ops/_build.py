"""Build the port's CUDA kernels at first use, load them with ctypes,
and count their launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into
``build/torch_kernels/<name>-<hash>.so`` at the root of the checkout,
where ``<hash>`` covers the sources in ``csrc/`` and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. The
sources have a plain C interface (no PyTorch headers), so a build takes
seconds. ``build_all()`` starts one ``nvcc`` per source at once.

A failed build raises with nvcc's own error output. Nothing here runs
when the package is imported: the CPU tests import every module and
never build.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# what each build printed (ptxas registers / shared memory / spills) and
# how long it took, for chip_smoke.py to report
build_logs: dict[str, str] = {}
build_seconds: dict[str, float] = {}

# launches per kernel name; each wrapper adds one right after its kernel
# was launched, and nowhere else (under a lock: the threads of a loopback
# mesh launch kernels at once)
_launches: dict[str, int] = {}
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _count_lock:
        _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


def kernel_names() -> list[str]:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ at "
                       "first use")


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns ``(proc, tmp, target, t0)`` or
    None when the library is already built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, target, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, target, t0 = started
    out, err = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = (out + err).strip()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{err}")
    os.replace(tmp, target)


def build_all(names=None) -> dict[str, float]:
    """Build every kernel (or ``names``) with one nvcc per source, all
    started together; returns the seconds each build took."""
    names = kernel_names() if names is None else list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    return {n: build_seconds.get(n, 0.0) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(_target(name))
                _libs[name] = lib
    return lib


# The storage types each kernel takes: float32 and bf16, all thirteen
# (the paged decode kernel's pool also int8; its wrapper checks its own
# operands). The ring all-gather, the hop and the all-to-all move bf16 as
# bytes; the ring all-reduce and reduce-scatter sum it; the flash kernels
# read bf16 tiles (the LM's mixed trunk and --dtype bfloat16); the FFN
# kernels and the fused head widen it into f32 scratch.
_BOTH = (torch.float32, torch.bfloat16)
DTYPES = {name: _BOTH for name in (
    "ppermute_dma", "ring_all_gather", "ring_all_reduce",
    "ring_reduce_scatter", "all_to_all_dma", "flash_attn_fwd",
    "flash_attn_bwd", "ffn_fwd", "ffn_bwd_dx", "ffn_bwd_dw",
    "head_xent_fwd", "head_xent_bwd")}
DTYPES["paged_decode_attn"] = _BOTH + (torch.int8,)


def on_card(name: str, *tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA
    tensors that the kernel takes (a storage type of ``DTYPES[name]``,
    float32 if it has no entry; contiguous; one device); raises on
    anything else. A wrapper whose kernel mixes types (the flash
    backward's f32 ``lse`` beside bf16 operands) checks their
    combination itself."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all operands must be on {dev}")
    allowed = DTYPES.get(name, (torch.float32,))
    if any(t.dtype not in allowed for t in tensors):
        raise ValueError(
            f"{name}: the kernel takes {[str(d) for d in allowed]} storage, "
            f"got {[str(t.dtype) for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all operands must be contiguous")
    return True


def bind(name: str, fn: str, n_ptrs: int, n_ints: int):
    """``csrc/<name>.cu``'s C function ``fn`` taking ``n_ptrs`` pointers,
    ``n_ints`` ints and the stream, returning a cudaError_t as int. Every
    pointer and the stream are passed as ``c_void_p``: left to ctypes'
    default they would be cut to 32 bits."""
    f = getattr(load_library(name), fn)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def launch(name: str, fn: str, ptrs, ints, device, count_as: str) -> None:
    """Launch ``fn`` of ``csrc/<name>.cu`` on ``device``'s current stream,
    raise on a CUDA error, and count one launch of ``count_as``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = bind(name, fn, len(ptrs), len(ints))(*ptrs, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {rc}")
    count_launch(count_as)
