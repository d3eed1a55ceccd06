"""The port's fit-and-FLOP dry run (``python -m repro_torch.launch.dryrun``)
in a subprocess, on ``meta``, for the reference's three
``tests/test_dryrun.py::test_dryrun_cell`` cells: smollm-360m
``train_4k``, nequip ``molecule`` and two-tower ``retrieval_cand``.

Where the reference checks its 512-device mesh and the v5e HBM fit, the
port's record is for one H100: its bytes against the card's memory (80 GiB
where no card is present, said so), a smallest mesh where it does not fit,
counted FLOPs (matrix products and attention) at least the model's, and the
roofline terms with their dominant one.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dryrun(tmp_path, *args):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                          env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)


@pytest.mark.parametrize("arch,shape,fits", [
    ("smollm-360m", "train_4k", False),
    ("nequip", "molecule", True),
    ("two-tower-retrieval", "retrieval_cand", True),
])
def test_dryrun_cell(tmp_path, arch, shape, fits):
    out = _dryrun(tmp_path, "--arch", arch, "--shape", shape, "--out", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    recs = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert recs == [f"{arch}__{shape}.json"]
    with open(tmp_path / recs[0]) as f:
        rec = json.load(f)
    assert (rec["arch"], rec["shape"]) == (arch, shape)
    assert rec["card_memory"] == {"bytes": 80 * 1024**3,
                                  "source": "no card here: an H100 80GB's 80 GiB assumed"}
    mem = rec["memory"]
    assert mem["per_device_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] > 0
    assert mem["fits_one_card"] is fits
    if fits:
        assert rec["smallest_mesh"] is None
    else:  # train_4k: B 256 x S 4,096 in 8 micro-batches needs a second card
        mesh = rec["smallest_mesh"]
        assert mesh["n_devices"] > 1 and mesh["mesh"][0] * mesh["mesh"][1] == mesh["n_devices"]
        assert mesh["per_device_bytes"] <= rec["card_memory"]["bytes"]
    rl = rec["roofline"]
    assert rl["compute_s"] > 0 and rl["memory_s"] > 0
    assert rl["dominant"] in ("compute", "memory")
    assert rl["step_time_s"] == max(rl["compute_s"], rl["memory_s"])
    assert rl["counted_flops"] >= rl["model_flops"] == rec["cost"]["model_flops_per_step"] > 0
    assert f"{arch}__{shape}: bytes/card=" in out.stdout
    if arch == "two-tower-retrieval":  # resumable: a second run reads the record back
        again = _dryrun(tmp_path, "--arch", arch, "--shape", shape, "--out", str(tmp_path))
        assert again.returncode == 0 and "skipped=1" in again.stdout, again.stdout


def test_dryrun_lists_the_40_cells(tmp_path):
    out = _dryrun(tmp_path, "--list")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")[:-1]
    assert len(lines) == 40 and lines[0] == "minicpm3-4b train_4k"
