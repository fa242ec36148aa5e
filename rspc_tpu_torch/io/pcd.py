"""PCD v0.7 point-cloud file I/O, ascii, binary and binary_compressed
(port of ``rspc_tpu/io/pcd.py``; numpy on the host, the port's own copy).

The reference's ``pcl::io::loadPCDFile`` / ``savePCDFileBinary`` /
``savePCDFileASCII`` on XYZRGB clouds (src/main.cpp:53,60,81,87,103,133,
src/icp_edge_based_registration.hpp:68,126). Colour:
  * ``rgb`` TYPE F, PCL's PointXYZRGB layout: the float's bit pattern is
    the packed ``0x00RRGGBB`` integer in binary files, while PCL's ascii
    writer prints the packed integer; integer-looking ascii tokens are
    read as packed integers, others by reinterpreting the float's bits;
  * ``rgb``/``rgba`` TYPE U: a plain packed uint32 (alpha ignored).

Organized clouds keep their WIDTH/HEIGHT, invalid points written as NaN
xyz. LZF (binary_compressed) runs in Python here: the JAX package's
native codec (``native/lzf.cpp``) is a separate library the port does
not load yet (ROADMAP.md Queue A: io/native). ``load_pcd`` puts the
cloud on ``device`` (the card unless the caller names the CPU).
"""

from __future__ import annotations

import io as _io
import os
from typing import Union

import numpy as np

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud

_DTYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
}


def _parse_header(f) -> dict:
    hdr = {}
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PCD header")
        line = line.decode("ascii", "replace").strip()
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        key = key.upper()
        hdr[key] = rest.split()
        if key == "DATA":
            hdr["DATA"] = rest.strip().lower()
            return hdr


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """Decompress LZF (libLZF format, as used by PCL binary_compressed)."""
    out = bytearray(expected)
    i, o, n = 0, 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            cnt = ctrl + 1
            out[o : o + cnt] = data[i : i + cnt]
            i += cnt
            o += cnt
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out[o] = out[ref]
                o += 1
                ref += 1
    return bytes(out[:o])


def _lzf_compress(data: bytes) -> bytes:
    """LZF compressor: greedy matches of three or more bytes against the
    last position of each 3-byte key, offsets below 8192."""
    n = len(data)
    out = bytearray()
    htab = {}
    lit_start = 0
    i = 0

    def flush_literals(end):
        nonlocal lit_start
        j = lit_start
        while j < end:
            cnt = min(32, end - j)
            out.append(cnt - 1)
            out.extend(data[j : j + cnt])
            j += cnt
        lit_start = end

    while i + 2 < n:
        key = data[i : i + 3]
        ref = htab.get(key, -1)
        htab[key] = i
        off = i - ref - 1
        if ref >= 0 and off < 8192:
            length = 3
            maxlen = min(n - i, 264)
            while length < maxlen and data[ref + length] == data[i + length]:
                length += 1
            flush_literals(i)
            l = length - 2
            if l < 7:
                out.append((l << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(l - 7)
            out.append(off & 0xFF)
            i += length
            lit_start = i
        else:
            i += 1
    flush_literals(n)
    return bytes(out)


def _pack_rgb(rgb: np.ndarray) -> np.ndarray:
    r = np.clip(rgb[..., 0], 0, 255).astype(np.uint32)
    g = np.clip(rgb[..., 1], 0, 255).astype(np.uint32)
    b = np.clip(rgb[..., 2], 0, 255).astype(np.uint32)
    return (r << 16) | (g << 8) | b


def _unpack_rgb(packed: np.ndarray) -> np.ndarray:
    packed = packed.astype(np.uint32)
    return np.stack(
        [
            (packed >> 16) & 0xFF,
            (packed >> 8) & 0xFF,
            packed & 0xFF,
        ],
        axis=-1,
    ).astype(np.float32)


def load_pcd(path: Union[str, os.PathLike], device="cuda") -> OrganizedCloud | Cloud:
    """Load a .pcd file onto ``device``: an OrganizedCloud when HEIGHT > 1,
    else a Cloud."""
    with open(path, "rb") as f:
        hdr = _parse_header(f)
        fields = hdr["FIELDS"]
        sizes = [int(s) for s in hdr["SIZE"]]
        types = hdr["TYPE"]
        counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(fields))]
        width = int(hdr["WIDTH"][0])
        height = int(hdr["HEIGHT"][0])
        npoints = int(hdr.get("POINTS", [width * height])[0])
        data_mode = hdr["DATA"]

        cols = []  # (field_name, numpy dtype, count)
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            cols.append((name, _DTYPES[(typ, size)], cnt))

        if data_mode == "ascii":
            raw_tokens = f.read().split()
            ncols = sum(c for _, _, c in cols)
            tokens = np.array(raw_tokens[: npoints * ncols]).reshape(npoints, ncols)
            arrays = {}
            ci = 0
            for (name, dt, cnt), typ in zip(cols, types):
                tok = tokens[:, ci : ci + cnt]
                ci += cnt
                if name in ("rgb", "rgba") and typ == "F":
                    # Auto-detect packed-int-as-value vs bit-reinterpreted.
                    vals = tok[:, 0].astype(np.float64)
                    is_intlike = np.all(
                        (vals >= 0) & (vals < 2**32) & (vals == np.floor(vals))
                    )
                    if is_intlike:
                        arrays[name] = vals.astype(np.uint32)
                    else:
                        arrays[name] = vals.astype(np.float32).view(np.uint32)
                else:
                    arrays[name] = tok.astype(dt)[:, 0] if cnt == 1 else tok.astype(dt)
        else:
            point_step = sum(s * c for s, c in zip(sizes, counts))
            if data_mode == "binary_compressed":
                comp_size, uncomp_size = np.frombuffer(f.read(8), np.uint32)
                blob = _lzf_decompress(f.read(int(comp_size)), int(uncomp_size))
                # SoA layout: all values of field 0, then field 1, ...
                arrays = {}
                off = 0
                for name, dt, cnt in cols:
                    nbytes = np.dtype(dt).itemsize * cnt * npoints
                    arr = np.frombuffer(blob[off : off + nbytes], dt)
                    off += nbytes
                    arrays[name] = arr.reshape(npoints, cnt)[:, 0] if cnt == 1 else arr
            elif data_mode == "binary":
                blob = f.read(point_step * npoints)
                rec = np.frombuffer(blob, np.uint8).reshape(npoints, point_step)
                arrays = {}
                off = 0
                for name, dt, cnt in cols:
                    w = np.dtype(dt).itemsize * cnt
                    arr = rec[:, off : off + w].copy().view(dt)
                    off += w
                    arrays[name] = arr[:, 0] if cnt == 1 else arr
            else:
                raise ValueError(f"unsupported DATA mode {data_mode!r}")
            for name in ("rgb", "rgba"):
                if name in arrays and arrays[name].dtype == np.float32:
                    arrays[name] = arrays[name].view(np.uint32)

    xyz = np.stack(
        [arrays["x"].astype(np.float32), arrays["y"].astype(np.float32),
         arrays["z"].astype(np.float32)],
        axis=-1,
    )
    if "rgb" in arrays:
        rgb = _unpack_rgb(arrays["rgb"])
    elif "rgba" in arrays:
        rgb = _unpack_rgb(arrays["rgba"])
    else:
        rgb = np.zeros_like(xyz)

    if height > 1:
        return OrganizedCloud.from_numpy(
            xyz.reshape(height, width, 3), rgb.reshape(height, width, 3), device=device
        )
    return Cloud.from_numpy(xyz, rgb, device=device)


def save_pcd(
    path: Union[str, os.PathLike],
    cloud: Union[Cloud, OrganizedCloud],
    mode: str = "binary",
    keep_invalid: bool = True,
) -> None:
    """Save a cloud as .pcd (FIELDS x y z rgb, matching PCL PointXYZRGB).

    ``mode``: "ascii" | "binary" | "binary_compressed".
    For unorganized clouds with ``keep_invalid=False``, only valid points are
    written (PCL's dynamically-sized clouds have no padding); with
    ``keep_invalid=True`` invalid rows are written verbatim only when the
    round trip is invariant, i.e. when ``load_pcd``'s validity rule
    (finite, z != 0) would mark them invalid again; invalid rows carrying
    real off-origin finite geometry (edge-compaction padding slots,
    masked non-converged frames) are written as NaN so they cannot
    silently resurrect as valid points on reload. The reference's own
    sample files (all-z==0 invalid points) still round-trip byte-exact
    like they do through PCL. Organized clouds always keep
    their full grid, with invalid pixels as NaN (PCL's organized-cloud
    convention).
    """
    host = lambda t: t.detach().cpu().numpy()
    organized = isinstance(cloud, OrganizedCloud)
    if organized:
        width, height = cloud.width, cloud.height
        xyz = host(cloud.xyz).astype(np.float32).reshape(-1, 3).copy()
        rgb = host(cloud.rgb).astype(np.float32).reshape(-1, 3)
        valid = host(cloud.valid).reshape(-1)
        xyz[~valid] = np.nan
    else:
        xyz = host(cloud.xyz).astype(np.float32)
        rgb = host(cloud.rgb).astype(np.float32)
        valid = host(cloud.valid)
        if not keep_invalid:
            xyz, rgb = xyz[valid], rgb[valid]
        else:
            xyz = xyz.copy()
            # Round-trip invariance: an invalid row may be written verbatim
            # only if load_pcd would mark it invalid again (z==0 or
            # non-finite); any other invalid row becomes NaN.
            resurrectable = (
                ~valid & (xyz[:, 2] != 0.0) & np.isfinite(xyz).all(axis=-1)
            )
            xyz[resurrectable] = np.nan
        width, height = xyz.shape[0], 1

    n = xyz.shape[0]
    packed = _pack_rgb(rgb)
    rgbf = packed.view(np.float32)

    buf = _io.BytesIO()
    hdr = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z rgb\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {width}\n"
        f"HEIGHT {height}\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {mode}\n"
    )
    buf.write(hdr.encode("ascii"))

    if mode == "ascii":
        lines = []
        for i in range(n):
            lines.append(
                f"{xyz[i, 0]:.9g} {xyz[i, 1]:.9g} {xyz[i, 2]:.9g} {packed[i]:d}"
            )
        buf.write(("\n".join(lines) + "\n").encode("ascii"))
    elif mode == "binary":
        rec = np.empty((n, 4), np.float32)
        rec[:, :3] = xyz
        rec[:, 3] = rgbf
        buf.write(rec.tobytes())
    elif mode == "binary_compressed":
        soa = b"".join(
            [
                xyz[:, 0].astype(np.float32).tobytes(),
                xyz[:, 1].astype(np.float32).tobytes(),
                xyz[:, 2].astype(np.float32).tobytes(),
                rgbf.tobytes(),
            ]
        )
        comp = _lzf_compress(soa)
        buf.write(np.array([len(comp), len(soa)], np.uint32).tobytes())
        buf.write(comp)
    else:
        raise ValueError(f"unsupported mode {mode!r}")

    with open(path, "wb") as f:
        f.write(buf.getvalue())
