"""The port stands alone: it imports neither ``jax`` nor the JAX package,
importing it builds nothing, and its entry points default to the card."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "triton")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_persistence_modules_are_checked():
    """The persistence and sharding modules (the WAL's and the live tail's
    too) are among the files checked above, and the packages export what
    the reference's do."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"storage/heap.py", "storage/wal.py", "storage/live_index.py",
            "core/directory.py", "core/query/live.py", "serve/kv_segments.py",
            "core/shard.py", "core/ingest_backend.py", "core/sharded.py",
            "serve/search_frontend.py"} <= checked
    import repro_torch.core as core
    import repro_torch.storage as storage

    assert {"PersistentHeap", "DEVICE_MODELS", "SSD", "PMEM", "DRAM"} <= set(storage.__all__)
    assert {"FSDirectory", "ByteAddressableDirectory", "RAMDirectory", "SimClock",
            "SearchEngine", "SegmentDeviceCache", "build_segment_reference",
            "merge_segments_reference", "Router", "HashIdRouter", "HashFieldRouter",
            "ShardSet", "EXT_ID_FIELD", "ShardedWriter", "ShardSearcher",
            "ShardedSearcher", "ShardedSearcherManager", "ShardedEngine"} <= set(core.__all__)
    assert all(hasattr(core, n) for n in core.__all__)


def test_lm_modules_are_checked():
    """The five LM configs and the model module are among the files checked
    above, and the model module exports the forward pass and the MoE FFNs."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"configs/minicpm3_4b.py", "configs/moonshot_v1_16b_a3b.py",
            "configs/phi3_5_moe_42b_a6_6b.py", "configs/qwen2_1_5b.py",
            "configs/smollm_360m.py", "models/transformer.py"} <= checked
    from repro_torch.models import transformer as tf

    assert {"lm_forward", "lm_loss", "lm_prefill", "lm_decode_step", "moe_ffn",
            "moe_ffn_hier", "moe_ffn_grouped", "init_lm_params",
            "init_kv_cache", "layer_shapes"} <= set(tf.__all__)
    assert all(hasattr(tf, n) for n in tf.__all__)


def test_training_modules_are_checked():
    """The training, recsys and NequIP modules are among the files checked
    above, and their packages export what the reference's do (the optimizer
    package with ``compressed_pod_mean``)."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"optim/adamw.py", "train/checkpoint.py", "train/loop.py", "train/tree.py",
            "data/lm.py", "data/prefetch.py", "data/graph.py", "data/recsys_data.py",
            "launch/train.py", "models/recsys.py", "models/nequip.py", "configs/nequip.py",
            "configs/xdeepfm.py", "configs/wide_deep.py", "configs/bert4rec.py",
            "configs/two_tower_retrieval.py", "configs/recsys_shapes.py"} <= checked
    import repro_torch.data as data
    import repro_torch.optim as optim
    import repro_torch.train as train

    assert {"AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
            "compressed_pod_mean"} <= set(optim.__all__)
    assert set(train.__all__) == {"CheckpointManager", "CheckpointConfig"}
    assert set(data.__all__) == {"synthetic_corpus", "CorpusConfig", "Prefetcher"}
    for pkg in (data, optim, train):
        assert all(hasattr(pkg, n) for n in pkg.__all__)


def test_distribution_modules_are_checked():
    """The distribution slice's modules are among the files checked above,
    ``repro_torch.distributed`` exports what ``repro.distributed`` does, and
    importing the slice loads no ``jax``, ``repro`` or ``triton`` and builds
    nothing."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    new = {"distributed/api.py", "distributed/cost.py", "launch/mesh.py",
           "launch/steps.py", "launch/dryrun.py", "optim/compression.py"}
    assert new <= checked
    import repro_torch.distributed as distributed

    assert set(distributed.__all__) == {"set_mesh", "get_mesh", "set_batch_axes", "shard",
                                        "named_sharding", "POD", "DATA", "MODEL", "BATCH"}
    assert all(hasattr(distributed, n) for n in distributed.__all__)
    mods = sorted("repro_torch." + m[:-3].replace("/", ".") for m in new)
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from repro_torch.kernels import runtime\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert runtime._lib is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_serve_exports_what_the_reference_exports():
    """``repro_torch.serve`` exports the serving front end's six names beside
    the LM serving ones."""
    import repro_torch.serve as serve

    assert {"FrontendClosed", "OverloadError", "PendingIngest", "PendingSearch",
            "SearchFrontend", "ShardFailedError", "KVSegmentStore", "Request",
            "ServeEngine"} == set(serve.__all__)
    assert all(hasattr(serve, n) for n in serve.__all__)


def test_import_loads_no_jax_and_builds_nothing():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import repro_torch\n"
        "from repro_torch.kernels import runtime\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert runtime._lib is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_default_device_is_the_card():
    """No device means CUDA on a Hopper card; anywhere else it raises and
    says how to ask for the CPU."""
    from repro_torch.core.engine import SearchEngine
    from repro_torch.kernels.runtime import resolve_device

    hopper = (torch.cuda.is_available()
              and torch.cuda.get_device_capability() == (9, 0))
    if hopper:
        assert SearchEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SearchEngine()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda")
    assert SearchEngine(device="cpu").device.type == "cpu"


def test_sharded_engine_default_device_is_the_card():
    """``ShardedEngine()`` resolves its device as ``SearchEngine`` does, before
    any shard or worker starts."""
    from repro_torch.core import ShardedEngine

    hopper = (torch.cuda.is_available()
              and torch.cuda.get_device_capability() == (9, 0))
    if hopper:
        eng = ShardedEngine(backend="serial")
        assert eng.device.type == "cuda"
        assert all(c.device.type == "cuda" for c in eng.device_caches)
        eng.close()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedEngine(backend="processes")
    eng = ShardedEngine(device="cpu", backend="serial")
    assert eng.device.type == "cpu"
    assert [c.device.type for c in eng.device_caches] == ["cpu", "cpu"]
    eng.close()


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the CUDA library and is not counted."""
    from repro_torch.kernels import term_topk as kt

    before = dict(kt.launches)
    z = torch.zeros(kt.TILE, dtype=torch.int32)
    kt.bm25_topk_blocks(z, z + 3, z, 1.0, 1.0, 0.9, 0.4, 10)
    assert kt.launches == before


def test_meta_tensors_take_the_plain_version():
    """A ``meta`` tensor (the dry run's shapes) takes the plain version: K10
    gives its output's shape and dtype, launches nothing and is not
    counted."""
    from repro_torch.kernels import decode_attn as kd

    before = dict(kd.launches)
    q = torch.empty((2, 5, 3, 64), device="meta", dtype=torch.bfloat16)
    kv = torch.empty((2, 5, 4096, 64), device="meta", dtype=torch.bfloat16)
    out = kd.decode_attn(q, kv, kv, torch.empty(2, dtype=torch.int32, device="meta"))
    assert (out.device.type, tuple(out.shape), out.dtype) == ("meta", (2, 5, 3, 64),
                                                              torch.float32)
    assert kd.launches == before


def test_header_edit_changes_library_path(tmp_path, monkeypatch):
    """The build is keyed by every file under csrc/, headers included, and
    nvcc compiles only the .cu sources."""
    import shutil

    from repro_torch.kernels import runtime

    csrc = tmp_path / "csrc"
    shutil.copytree(runtime.CSRC, csrc)
    monkeypatch.setattr(runtime, "CSRC", csrc)
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert headers, "csrc/ holds no header"
    assert [p.suffix for p in runtime._sources()] == [".cu"] * len(runtime._sources())
    before = runtime.library_path()
    assert runtime.library_path() == before  # deterministic
    header = csrc / headers[0]
    header.write_text(header.read_text() + "\n// edited\n")
    assert runtime.library_path() != before
