"""Small cells for the harness's CPU tests: the cells of
``BENCHMARK.json`` at 80x60 with 3-frame sweeps, the voxel grid's
capacity a slot per pixel as at full size, and limits for ``correct``
of their own: with some 1,500 voxel means a frame, the port's plain
path on the CPU reads up to 2.42e-4 (``pair_gap``) and 3.20e-4
(``map_gap``) from the reference over 5 seeds x 8 sweeps, above the
full-size cells' limits; the tests' faults move a transform by 1 mm."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WIDTH, HEIGHT, FRAMES = 80, 60, 3
LIMITS = {"pair_gap": 6e-4, "map_gap": 6e-4, "map_valid_mismatch": 0}


def tiny(name: str) -> dict:
    from bench_port import spec

    cell = spec.cell(name)
    cell["config"]["camera"].update(width=WIDTH, height=HEIGHT)
    cell["config"]["pipeline"]["voxel"]["max_points"] = WIDTH * HEIGHT
    cell["mix"].update(frames=FRAMES)
    cell["limits"] = dict(LIMITS)
    return cell
