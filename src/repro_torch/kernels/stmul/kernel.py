"""Hopper CUDA kernels of the serving path and their ctypes wrappers.

The sources live in ``csrc/stmul.cu`` (plain C entry points, see the
note at its top for what each kernel replaces, what bounds it on the
card and how its design answers that).  They are compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository root
on first use, keyed by a hash of the sources, and loaded with
``ctypes``.  Nothing here runs at import time: the CPU tests import
this module on hosts with no ``nvcc`` and no card.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch reported an error,
and adds one to its ``launches`` counter.  The plain torch versions the
wrappers are held against live in :mod:`repro_torch.kernels.stmul.ref`;
the routing between the two (by the tensor's device) is in
:mod:`repro_torch.kernels.stmul.ops`.
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
from typing import Sequence

import torch

Tensor = torch.Tensor

TOPK_MAX_K = 32  # per-thread candidate buffer of the readout kernel
MAC_THREADS = 256  # threads per block of the MAC kernels (one per bin)

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
_ARCH = "arch=compute_90a,code=sm_90a"

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None  # the loaded library; written under _lib_lock
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the stmul CUDA kernels cannot be built")


def build() -> dict:
    """Compile (if needed) and load the kernel library.

    Returns ``{"path", "seconds", "log"}``: the shared object, the wall
    time this call spent, and the compiler's resource report
    (``-Xptxas -v``) when this call ran ``nvcc`` (else empty)."""
    global _lib
    t0 = time.perf_counter()
    srcs = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha1()
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = _BUILD_DIR / f"libstmul-{digest.hexdigest()[:16]}.so"
    log = ""
    with _lib_lock:
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                _nvcc(), "-gencode", _ARCH, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                "-o", str(tmp), *[str(p) for p in srcs],
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so)
            log = proc.stdout + proc.stderr
        if _lib is None or Path(_lib._name) != so:
            lib = ctypes.CDLL(str(so))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.stmul_mac.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, i32, vp]
            lib.stmul_mac.restype = i32
            lib.stmul_mac_grouped.argtypes = [
                vp, vp, vp, vp, vp, i32, i32, i64, i32, i32, i32, vp,
            ]
            lib.stmul_mac_grouped.restype = i32
            lib.stmul_topk.argtypes = [vp, vp, vp, vp, i32, i64, i32, vp]
            lib.stmul_topk.restype = i32
            _lib = lib
    return {
        "path": str(so),
        "seconds": time.perf_counter() - t0,
        "log": log,
    }


def _library() -> ctypes.CDLL:
    with _lib_lock:
        lib = _lib
    if lib is None:
        build()
        with _lib_lock:
            lib = _lib
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    with _count_lock:
        for fn in (spectral_mac_cuda, spectral_mac_grouped_cuda, topk_readout_cuda):
            fn.launches = 0


def _require(t: Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def spectral_mac_cuda(x: Tensor, g: Tensor, version: int = 2) -> Tensor:
    """B1: ``y[b, o, f] = Σ_c x[b, c, f] · g[o, c, f]`` on complex64
    (B, C, F) and (O, C, F); returns complex64 (B, O, F)."""
    _require(x, "x", torch.complex64, 3)
    _require(g, "g", torch.complex64, 3)
    B, C, F = x.shape
    O = g.shape[0]
    if g.shape[1:] != (C, F) or g.device != x.device:
        raise ValueError(f"grating {tuple(g.shape)} does not match x {tuple(x.shape)}")
    if version not in (1, 2):
        raise ValueError(f"unknown stmul kernel version {version!r}")
    if not (0 < B <= 65535 and 0 < O <= 65535):
        raise ValueError(f"B={B}, O={O} outside the kernel's grid limits")
    y = torch.empty((B, O, F), dtype=torch.complex64, device=x.device)
    rc = _library().stmul_mac(
        x.data_ptr(), g.data_ptr(), y.data_ptr(), B, O, C, F, int(version),
        MAC_THREADS, _stream(),
    )
    _check(rc, "stmul_mac")
    _count(spectral_mac_cuda)
    return y


def spectral_mac_grouped_cuda(
    x: Tensor,
    pool_re: Tensor,
    pool_im: Tensor,
    o_start: Sequence[int],
    n_out: int,
) -> Tensor:
    """B2: ``y[b, o, f] = Σ_c x[b, c, f] · g[o_start[b] + o, c, f]`` with
    x complex64 (B, C, F) and split arena planes (ΣO, C, F) float32 or
    bfloat16; ``o_start`` holds B host-side row offsets.  Returns
    complex64 (B, n_out, F)."""
    _require(x, "x", torch.complex64, 3)
    if pool_re.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"arena planes must be float32 or bfloat16, got {pool_re.dtype}")
    _require(pool_re, "pool_re", pool_re.dtype, 3)
    _require(pool_im, "pool_im", pool_re.dtype, 3)
    B, C, F = x.shape
    rows = int(pool_re.shape[0])
    if pool_re.shape[1:] != (C, F) or pool_im.shape != pool_re.shape:
        raise ValueError(
            f"arena planes {tuple(pool_re.shape)} do not match x {tuple(x.shape)}"
        )
    offs = [int(o) for o in o_start]
    if len(offs) != B:
        raise ValueError(f"o_start has {len(offs)} entries for {B} rows")
    n_out = int(n_out)
    if min(offs) < 0 or max(offs) + n_out > rows:
        raise ValueError(
            f"o_start + n_out reads rows up to {max(offs) + n_out} of an "
            f"arena of {rows}"
        )
    if not (0 < B <= 65535 and 0 < n_out <= 65535):
        raise ValueError(f"B={B}, n_out={n_out} outside the kernel's grid limits")
    off = torch.tensor(offs, dtype=torch.int32, device=x.device)
    y = torch.empty((B, n_out, F), dtype=torch.complex64, device=x.device)
    rc = _library().stmul_mac_grouped(
        x.data_ptr(), pool_re.data_ptr(), pool_im.data_ptr(), off.data_ptr(),
        y.data_ptr(), B, C, F, n_out, int(pool_re.dtype == torch.bfloat16),
        MAC_THREADS, _stream(),
    )
    _check(rc, "stmul_mac_grouped")
    _count(spectral_mac_grouped_cuda)
    return y


def topk_readout_cuda(vals: Tensor, gidx: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """B3: per row of ``vals`` (R, L) float32 the k best (score, index)
    pairs, ``gidx`` (L,) int32 the shared global positions.  Returns
    (R, k) float32 scores and int32 indices, bitwise equal to
    :func:`repro_torch.kernels.stmul.ref.topk_select`."""
    _require(vals, "vals", torch.float32, 2)
    _require(gidx, "gidx", torch.int32, 1)
    R, L = vals.shape
    k = int(k)
    if gidx.shape[0] != L:
        raise ValueError(f"gidx has {gidx.shape[0]} entries for L={L}")
    if not 1 <= k <= TOPK_MAX_K:
        raise ValueError(f"k={k} outside 1..{TOPK_MAX_K}")
    if L == 0:
        raise ValueError("empty score axis")
    s = torch.empty((R, k), dtype=torch.float32, device=vals.device)
    ix = torch.empty((R, k), dtype=torch.int32, device=vals.device)
    if R == 0:
        return s, ix
    rc = _library().stmul_topk(
        vals.data_ptr(), gidx.data_ptr(), s.data_ptr(), ix.data_ptr(), R, L, k,
        _stream(),
    )
    _check(rc, "stmul_topk")
    _count(topk_readout_cuda)
    return s, ix


spectral_mac_cuda.launches = 0
spectral_mac_grouped_cuda.launches = 0
topk_readout_cuda.launches = 0
