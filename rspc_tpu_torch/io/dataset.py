"""Dataset directory conventions, as the reference has them (port of
``rspc_tpu/io/dataset.py``).

The reference keeps everything under ``dataset/``:
  * capture writes ``dataset/{prefix}-{i}.pcd`` (src/main.cpp:53),
  * registration loads those (src/main.cpp:79-83) and writes
    ``dataset/{prefix}-registration``, without a ``.pcd`` extension, a
    reference quirk kept here (src/main.cpp:87),
  * the edge scheme writes ``dataset/edge-{i}.pcd`` and
    ``dataset/edge_cloud.pcd`` (src/icp_edge_based_registration.hpp:66-69,126),
  * ``--all`` writes ``dataset/{file}.pcd`` (src/main.cpp:133).

Clouds are read on the host and put on an explicit ``device`` (the card
unless the caller names the CPU).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Union

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud
from rspc_tpu_torch.io import native
from rspc_tpu_torch.io.pcd import load_pcd, save_pcd

CloudLike = Union[Cloud, OrganizedCloud]


def dataset_path(prefix: str, index: int, dataset_dir: str = "dataset") -> str:
    return os.path.join(dataset_dir, f"{prefix}-{index}.pcd")


def _peek_header(path: str):
    """(width, height, data_mode, standard_layout) from the PCD header."""
    hdr = {}
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("ascii", "replace").strip()
            if line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            hdr[key] = rest
            if key == "DATA":
                break
    std = (
        hdr.get("FIELDS") == "x y z rgb"
        and hdr.get("SIZE") == "4 4 4 4"
        and hdr.get("TYPE") == "F F F F"
        and hdr.get("COUNT", "1 1 1 1") == "1 1 1 1"
    )
    return (
        int(hdr.get("WIDTH", 0)),
        int(hdr.get("HEIGHT", 1)),
        hdr.get("DATA", ""),
        std,
    )


def load_dataset_clouds(
    prefix: str, frames: int, dataset_dir: str = "dataset", device="cuda"
) -> List[CloudLike]:
    """Load ``dataset/{prefix}-{i}.pcd`` for i in [0, frames) onto
    ``device`` (reference: src/main.cpp:79-83).

    Standard-layout files (x/y/z/rgb float records, everything this
    package writes) go through the native threaded loader
    (native/loader.cpp), one worker per file, into padded host buffers;
    a file it cannot parse, and every file when the library is
    unavailable or a header is not standard, goes through ``load_pcd``."""
    paths = [dataset_path(prefix, i, dataset_dir) for i in range(frames)]
    try:
        heads = [_peek_header(p) for p in paths]
    except (OSError, ValueError):
        heads = None
    if heads is not None and all(h[3] for h in heads):
        cap = max(h[0] * h[1] for h in heads)
        loaded = native.load_dataset(paths, cap) if cap > 0 else None
        if loaded is not None:
            xyz, rgb, valid, counts = loaded
            out: List[CloudLike] = []
            for i, (w, h, _, _) in enumerate(heads):
                if counts[i] < 0:  # per-file fallback
                    out.append(load_pcd(paths[i], device=device))
                    continue
                n = w * h
                if h > 1 and counts[i] == n:
                    out.append(
                        OrganizedCloud.from_numpy(
                            xyz[i, :n].reshape(h, w, 3),
                            rgb[i, :n].reshape(h, w, 3),
                            valid[i, :n].reshape(h, w),
                            device=device,
                        )
                    )
                else:
                    out.append(
                        Cloud.from_numpy(
                            xyz[i, :n], rgb[i, :n], valid=valid[i, :n],
                            device=device,
                        )
                    )
            return out
    return [load_pcd(p, device=device) for p in paths]


def save_dataset_clouds(
    prefix: str,
    clouds: Sequence[CloudLike],
    dataset_dir: str = "dataset",
    mode: str = "binary",
) -> None:
    """Save clouds as ``dataset/{prefix}-{i}.pcd`` (reference: src/main.cpp:52-53)."""
    os.makedirs(dataset_dir, exist_ok=True)
    for i, c in enumerate(clouds):
        save_pcd(dataset_path(prefix, i, dataset_dir), c, mode=mode)


def registration_output_path(prefix: str, dataset_dir: str = "dataset") -> str:
    """Reference quirk kept: no ``.pcd`` extension (src/main.cpp:87)."""
    return os.path.join(dataset_dir, f"{prefix}-registration")
