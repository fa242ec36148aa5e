"""``chip_smoke.py`` outside its machine: on a host without a CUDA card it
must exit non-zero at once, build nothing and print no result; alone in
a directory without the package it must fail too."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")
BUILD = os.path.join(ROOT, "rspc_tpu_torch", "_build")


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_fails_fast_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py runs for real here")
    before = sorted(os.listdir(BUILD)) if os.path.isdir(BUILD) else None
    out = _run(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr
    after = sorted(os.listdir(BUILD)) if os.path.isdir(BUILD) else None
    assert after == before  # nothing was built


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
