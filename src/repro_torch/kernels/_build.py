"""Build, load and launch the hand-written CUDA libraries (``nvcc`` + ``ctypes``).

Each kernel family keeps its sources in ``kernels/<name>/csrc/*.cu``
behind a plain C interface.  :class:`CudaLibrary` compiles them for
``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the repository
root on first use, keyed by a hash of that family's own sources, loads
the result with ``ctypes`` and declares every entry point's argument
types.  Nothing runs at import time: the CPU tests import the kernel
modules on hosts with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "arch=compute_90a,code=sm_90a"

# ctypes argument codes of the C entry points: pointers and the stream
# are c_void_p (a bare int would be cut to 32 bits), sizes int or int64,
# scalars float
VP, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaLibrary:
    """One shared library built from ``csrc/*.cu``.

    ``signatures`` maps each C entry point to its ``argtypes``; every
    entry point returns a ``cudaError_t`` as an int."""

    def __init__(self, name: str, csrc: Path, signatures: dict[str, list]):
        self.name = name
        self.csrc = Path(csrc)
        self.signatures = signatures
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None  # guarded-by: _lock

    def build(self) -> dict:
        """Compile (if needed) and load the library.

        Returns ``{"path", "seconds", "log"}``: the shared object, the
        wall time this call spent, and the compiler's resource report
        (``-Xptxas -v``) when this call ran ``nvcc`` (else empty)."""
        t0 = time.perf_counter()
        srcs = sorted(self.csrc.glob("*.cu"))
        digest = hashlib.sha1()
        for p in srcs:
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        so = BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"
        log = ""
        with self._lock:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                cmd = [
                    _nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                    "-o", str(tmp), *[str(p) for p in srcs],
                ]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {self.name} ({proc.returncode}):\n"
                        f"{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, so)
                log = proc.stdout + proc.stderr
            if self._lib is None or Path(self._lib._name) != so:
                lib = ctypes.CDLL(str(so))
                for fn, argtypes in self.signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = I32
                self._lib = lib
        return {"path": str(so), "seconds": time.perf_counter() - t0, "log": log}

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built on first use."""
        with self._lock:
            lib = self._lib
        if lib is None:
            self.build()
            with self._lock:
                lib = self._lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream() -> int:
    """The current CUDA stream, as the C entry points take it."""
    return torch.cuda.current_stream().cuda_stream


_count_lock = threading.Lock()


def count(fn, route: str | None = None) -> None:
    """Add one to a wrapper's ``launches`` counter and, for a wrapper with
    several routes, to its ``route_launches[route]``."""
    with _count_lock:
        fn.launches += 1
        if route is not None:
            fn.route_launches[route] += 1


def reset(*fns) -> None:
    """Set the given wrappers' ``launches`` counters (and per-route
    counters) to 0."""
    with _count_lock:
        for fn in fns:
            fn.launches = 0
            if hasattr(fn, "route_launches"):
                fn.route_launches = dict.fromkeys(fn.route_launches, 0)
