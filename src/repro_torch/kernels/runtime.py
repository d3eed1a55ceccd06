"""Where the port runs, and the CUDA library its kernels live in.

Counterpart of ``repro/kernels/runtime.py``, which decides whether a Pallas
kernel is compiled or interpreted.  The port has no interpreter: a kernel
runs on the card or not at all.

  * ``resolve_device(None)`` is ``"cuda"``.  It raises unless CUDA is
    present and the card is compute capability 9.0 (Hopper); the message
    tells the caller to pass ``device="cpu"``, which only the tests do.
  * ``library()`` builds ``csrc/*.cu`` on first use with ``nvcc`` into a
    shared library with a plain C interface and loads it with ``ctypes``:
    one ``nvcc -c`` per source, all started together, then one link.  The
    build is keyed by the content of every file under ``csrc/`` (the
    ``*.cu`` sources and the ``*.cuh``/``*.h`` headers they include), lands
    in ``_build/`` beside this package, and raises with nvcc's stderr if it
    fails.  Nothing here runs at import time.
  * ``python_library()`` is the same library through a ``ctypes.PyDLL``
    handle, whose calls keep the GIL: for its host routines that read
    Python objects (``csrc/stage_rows.cu``, built against the running
    interpreter's headers).

Kernel wrappers take their plain PyTorch version only for tensors that lie
on the CPU (or on ``meta``, where nothing is computed); a CUDA tensor
launches the kernel or raises.  There is no switch that turns the kernels
off on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sysconfig
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
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # Python.h, for the host routines that read Python objects
    "-I", sysconfig.get_paths()["include"],
)
#: what the build digest covers: the sources and the headers they include
SOURCE_GLOBS = ("*.cu", "*.cuh", "*.h")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_pylib: Optional[ctypes.PyDLL] = None
#: what the last build printed (``-Xptxas -v``: registers, shared memory,
#: spills per kernel) and how long it took; empty when the library came
#: from an earlier build with the same sources
build_info = {"log": "", "seconds": 0.0, "path": ""}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device must be a Hopper card;
    ``meta`` (shapes only, for the dry run) is taken as it is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type in ("cpu", "meta"):
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
    """The sources nvcc compiles: ``csrc/*.cu`` (headers are included)."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library built from the current ``csrc/`` lives: keyed by
    the name and content of every source and header, and the flags."""
    files = sorted({p for g in SOURCE_GLOBS for p in CSRC.glob(g)})
    digest = hashlib.sha256()
    for p in files:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands together; raise with stderr if any fails.  Returns
    their combined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    log, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        log.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log)


def _build() -> Path:
    out = library_path()
    build_info["path"] = str(out)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a private directory beside the target, then rename:
    # concurrent first uses never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        t0 = time.perf_counter()
        try:
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                            for src, o in zip(_sources(), objs)])
            lib = Path(tmp) / out.name
            log += _run_all([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]])
        finally:
            build_info["seconds"] = time.perf_counter() - t0
        build_info["log"] = log
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            sigs = {  # name: argument types; every launch returns a CUDA error code
                "term_topk": [vp] * 6 + [f32] * 3 + [i32] * 4 + [vp] * 4,
                "term_topk_blocks_per_sm": [i32],
                "term_topk_layout": [i32],
                "bm25_topk": [vp] * 3 + [f32] * 4 + [i32] * 3 + [vp] * 3,
                "bool_topk": [vp] * 6 + [f32] * 3 + [i32] * 6 + [vp] * 4,
                "sort_topk": [vp] * 6 + [i32] * 4 + [vp] * 4,
                "doc_topk_blocks_per_sm": [i32, i32],
                "doc_topk_layout": [i32],
                "range_topk": [vp] * 4 + [i32] * 4 + [vp] * 4,
                "facet_hist": [vp] * 6 + [i32] * 5 + [vp] * 4,
                "vector_topk": [vp, i32, i32, vp, vp] + [i32] * 6 + [vp] * 5,
                "hybrid_topk": ([vp, i32, i32, vp, vp] + [i32] * 3 + [vp] * 6
                                + [f32] * 3 + [i32] * 3 + [vp] * 5),
                "vector_score_rows": [vp, i32, i32, vp, vp] + [i32] * 5 + [vp] * 3,
                "hybrid_score_rows": ([vp, i32, i32, vp, vp] + [i32] * 3 + [vp] * 6
                                      + [f32] * 3 + [i32] * 2 + [vp] * 3),
                "bitset_combine": [vp, i32, ctypes.c_longlong, i32, i32] + [vp] * 5,
                "bitset_blocks_per_sm": [],
                "bitset_layout": [i32],
                "decode_attn": ([vp] * 4 + [i32] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                                + [f32] + [i32] * 7 + [vp] * 5),
                "decode_attn_blocks_per_sm": [i32] * 9,
            }
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = i32
            for name in ("kernels_tile", "kernels_max_k", "facet_shared_bins",
                         "vector_rows", "vector_docs",
                         "vector_dim_align", "decode_attn_tile",
                         "decode_attn_stages", "decode_attn_warps"):
                getattr(lib, name).restype = i32
            lib.cuda_error_string.argtypes = [i32]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def python_library() -> ctypes.PyDLL:
    """The kernels' library through a handle that keeps the GIL across a
    call, for its host routines that read Python objects."""
    global _pylib
    library()  # builds
    with _lock:
        if _pylib is None:
            lib = ctypes.PyDLL(build_info["path"])
            lib.stage_rows.argtypes = [ctypes.py_object, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
            lib.stage_rows.restype = ctypes.c_int
            _pylib = lib
        return _pylib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a CUDA error returned by a launch."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def takes_plain(t: torch.Tensor) -> bool:
    """Does a kernel wrapper run its plain version on ``t``?  On a CPU
    tensor it computes; on a ``meta`` tensor it only propagates shapes
    (the dry run).  A CUDA tensor launches the kernel or raises."""
    return t.device.type in ("cpu", "meta")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def one_wave(n_items: int, blocks_per_sm: int, device: torch.device) -> int:
    """The grid of a one-wave launch: the blocks the card holds at once
    (``blocks_per_sm`` from the occupancy API, times the SMs), at most one
    a work item."""
    return max(1, min(n_items, blocks_per_sm * sm_count(device)))


_scratch = {}  # (owner, device index, stream) -> zeroed int32 tensor


def zeroed_scratch(owner: str, dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for ``owner``'s launches on ``stream``,
    which its kernel leaves zero: allocated (and zeroed) once, grown when a
    call needs more."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (owner, index, stream)
    t = _scratch.get(key)
    if t is None or t.numel() < n:
        t = _scratch[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=torch.device("cuda", index))
    return t
