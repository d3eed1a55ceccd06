"""Where the port runs, and the CUDA library its kernels live in.

Counterpart of ``repro/kernels/runtime.py``, which decides whether a Pallas
kernel is compiled or interpreted.  The port has no interpreter: a kernel
runs on the card or not at all.

  * ``resolve_device(None)`` is ``"cuda"``.  It raises unless CUDA is
    present and the card is compute capability 9.0 (Hopper); the message
    tells the caller to pass ``device="cpu"``, which only the tests do.
  * ``library()`` builds ``csrc/*.cu`` on first use with ``nvcc`` into a
    shared library with a plain C interface and loads it with ``ctypes``.
    The build is keyed by the sources' content, lands in ``_build/`` beside
    this package, and raises with nvcc's stderr if it fails.  Nothing here
    runs at import time.

Kernel wrappers take their plain PyTorch version only for tensors that lie
on the CPU; a CUDA tensor launches the kernel or raises.  There is no switch
that turns the kernels off on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build printed (``-Xptxas -v``: registers, shared memory,
#: spills per kernel) and how long it took; empty when the library came
#: from an earlier build with the same sources
build_info = {"log": "", "seconds": 0.0, "path": ""}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device must be a Hopper card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA Hopper card and CUDA is not "
            "available here; pass device='cpu' to run the plain PyTorch "
            "versions of its kernels"
        )
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(
            f"repro_torch's kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(dev)} is compute capability "
            f"{cap[0]}.{cap[1]}; pass device='cpu' to run the plain versions"
        )
    return dev


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build() -> Path:
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    build_info["path"] = str(out)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target, then rename: concurrent first uses never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.term_topk.argtypes = [vp] * 6 + [f32] * 3 + [i32] * 3 + [vp] * 4
            lib.term_topk.restype = i32
            lib.bm25_topk.argtypes = [vp] * 3 + [f32] * 4 + [i32] * 2 + [vp] * 3
            lib.bm25_topk.restype = i32
            lib.term_topk_tile.restype = i32
            lib.term_topk_max_k.restype = i32
            lib.term_topk_error_string.argtypes = [i32]
            lib.term_topk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a CUDA error returned by a launch."""
    if code != 0:
        msg = lib.term_topk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
