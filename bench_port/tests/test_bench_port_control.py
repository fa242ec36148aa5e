"""On the card, at each cell's own size, for one seed: the program's
answers pass every limit, and the control (the reference in TF32, put in
the program's place) fails at least one. The limits themselves were set
from a dozen seeds and more (``control.py``, PERF.md).

    python -m pytest -m cuda --noconftest bench_port/tests/test_bench_port_control.py
"""

import pytest

from _tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)

from bench_port import spec

CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench_port.control import readings
    from rspc_tpu_torch import cuda_build

    cuda_build.library()
    cell = spec.cell(name)
    r = readings(cell, 2**31 + 101, program=True)
    limits = cell["limits"]
    assert any(v > limits[k] for k, v in r["control"].items()), r
    assert all(v <= limits[k] for k, v in r["program"].items()), r
