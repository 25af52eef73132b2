"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and is compiled
on its own by ``nvcc`` into ``_build/<name>-<hash>.so`` (the hash is of the
source and the ``csrc/*.cuh`` headers, so an edited source or header is
rebuilt and a stale library is never loaded).
All missing libraries are built together, one ``nvcc`` process per source, the
first time any kernel is launched.  Nothing here runs at import time: the CPU
tests import every module on a machine with no ``nvcc``.

The build directory is the kernels' only compile cache that persists on disk
(the warm-start layer, ``exec/compile_cache.py``): :func:`set_build_dir`
re-points it and drops the handles loaded from the old one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch
from torch.distributed.tensor import DTensor

CSRC = pathlib.Path(__file__).with_name("csrc")
DEFAULT_BUILD_DIR = pathlib.Path(__file__).with_name("_build")   # gitignored
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output by source stem, from the builds this process ran: with
# ``-Xptxas -v`` it names each kernel's registers, shared memory and spills.
LOGS: dict[str, str] = {}


def set_build_dir(path: str | os.PathLike) -> pathlib.Path:
    """Build and load the libraries in ``path`` from now on.  Drops the
    loaded libraries (``load``'s table) and the declared functions
    (``function``'s cache): a handle kept from the old directory would go on
    serving every launch, and the re-point would be a silent no-op.  ``path``
    equal to the current directory only drops them."""
    global BUILD_DIR
    path = pathlib.Path(path)
    with _lock:
        BUILD_DIR = path
        _libs.clear()
        function.cache_clear()
    return path


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} at first use and need the CUDA toolkit")


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    """The library of ``src``, named by a hash of the source, the headers
    beside it (``csrc/*.cuh``, which a source may include) and the flags."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all at once; returns
    the wall seconds spent (0.0 when everything was already built)."""
    todo = [(s, out) for s in sorted(CSRC.glob("*.cu")) if not (out := _lib_path(s)).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        LOGS[src.stem] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all kernels first
    if any library is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(CSRC / f"{name}.cu")))
            _libs[name] = lib
        return lib


@functools.cache
def function(lib: str, name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``csrc/<lib>.cu``, with its signature
    declared: undeclared, ctypes would pass each pointer as a 32-bit int.
    Every kernel entry returns a ``cudaError_t``."""
    f = getattr(load(lib), name)
    f.argtypes, f.restype = list(argtypes), ctypes.c_int
    return f


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned after a launch: a launch
    the card refuses never runs, and a later synchronise does not report it."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype code: 0 = float32, 1 = bfloat16."""
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer-sized int.
    PyTorch's own launchers read it with this call; the public route builds a
    Stream object first, several microseconds a launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def refuse_grad(kernel: str, brings: str, *tensors: torch.Tensor | None) -> None:
    """Raise where autograd would record a launch of a kernel that has no
    backward kernel: its output would carry no gradient, and a training step
    would silently drop every gradient through it.  ``brings`` names what
    gives the kernel its backward."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: an input requires grad, and this CUDA kernel has no backward kernel "
            f"({brings}); it refuses rather than return an output without a gradient")


def refuse_dtensor(kernel: str, *tensors: torch.Tensor | None) -> None:
    """Raise where a DTensor reaches a kernel wrapper: the kernels (and their
    plain versions) take local tensors, a stage's ``.to_local()`` shard or a
    plain tensor.  Taking a DTensor's local shard here, or gathering it,
    would quietly compute on another value than the caller laid out."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{kernel}: got a DTensor; pass its local shard (.to_local()) or a "
                        "plain tensor")
