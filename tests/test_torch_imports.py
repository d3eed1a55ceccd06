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


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the CUDA library and is not counted."""
    from repro_torch.kernels import term_topk as kt

    before = dict(kt.launches)
    z = torch.zeros(kt.TILE, dtype=torch.int32)
    kt.bm25_topk_blocks(z, z + 3, z, 1.0, 1.0, 0.9, 0.4, 10)
    assert kt.launches == before
