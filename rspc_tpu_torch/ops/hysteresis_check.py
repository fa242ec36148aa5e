"""Adversarial cases for Canny hysteresis (kernel B3).

Numpy masks made from a seed and sized by argument, the counterpart of
``ops/nn_check.py`` for the NN sweep. Each case is ``(name, strong,
weak)``, bool ``[B, H, W]`` arrays, one batched call of the kernel. The
result of every case is the union of the 8-connected components of
``strong | weak`` that hold a strong pixel, and no pixel of another
frame, or of the other end of a row, may reach into it. The cases:

  * ``serpentine``: one weak path that snakes through every row, cut
    once near the middle, strong at the far end of the path (the longest
    chain the frame can hold: it crosses every tile border, and a
    fixpoint of directional sweeps needs a round per turn);
  * ``double_spiral``: two interleaved square spirals, one empty pixel
    between their arms, strong at the outer end of one only;
  * ``percolation_0.41``, ``percolation_0.6``: random weak masks near and
    above the 8-connected percolation threshold (one component spanning
    the frame), a few strong pixels inside weak;
  * ``strong_outside_weak``: strong drawn independently of weak;
  * ``all_weak_one_strong`` and ``no_strong``;
  * ``frame_edge_leak``: two frames, weak across frame 0's last row and
    frame 1's first row, strong only in frame 1;
  * ``row_wrap_leak``: strong at one end of a row and weak at the other
    end or on the next row's far end (the flattened index's neighbours
    in every direction), which must stay dark;
  * ``ragged_37x33``, ``ragged_1xW``, ``ragged_Hx1``: random masks on
    frames whose sides are not multiples of any tile;
  * ``crease_bands``: masks shaped like the high-curvature class's (Canny
    on the normal image): dense weak bands a few pixels wide along
    straight creases at every angle, crossing one another and the tile
    borders, over sparse weak speckle, with strong seeds in only three
    bands.

``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` run every case
through the kernel at 480x640; ``tests/test_torch_image_ops.py`` holds
the plain version against the JAX package and a ``scipy.ndimage.label``
oracle on them at 48x64.
"""

from __future__ import annotations

import numpy as np

MIN_H, MIN_W = 16, 8  # the row-wrap case needs 15 rows


def random_masks(rng, shape, p_weak, p_strong):
    """(strong, weak): weak with probability ``p_weak``, strong inside
    weak with probability ``p_strong``."""
    weak = rng.random(shape) < p_weak
    return weak & (rng.random(shape) < p_strong), weak


def _serpentine(h, w):
    """Every even row weak, joined at alternate ends through the odd
    rows; strong at the path's last pixel; the middle connector cut."""
    weak = np.zeros((h, w), bool)
    weak[::2] = True
    rows = list(range(0, h - 1, 2))
    for i, r in enumerate(rows[:-1]):
        weak[r + 1, w - 1 if i % 2 == 0 else 0] = True
    cut = rows[len(rows) // 2]
    weak[cut + 1] = False
    strong = np.zeros((h, w), bool)
    last = rows[-1]
    strong[last, 0 if (len(rows) - 1) % 2 == 1 else w - 1] = True
    return strong, weak


def _spiral(h, w, cy, cx, step):
    """Pixels of a square spiral from (cy, cx), arms ``step`` apart,
    up to the first pixel outside the frame (so it stays one path)."""
    pts = [(cy, cx)]
    y, x, length, k = cy, cx, step, 0
    while True:
        for _ in range(2):
            dy, dx = ((0, 1), (1, 0), (0, -1), (-1, 0))[k % 4]
            for _ in range(length):
                y, x = y + dy, x + dx
                if not (0 <= y < h and 0 <= x < w):
                    return pts
                pts.append((y, x))
            k += 1
        length += step


def _double_spiral(h, w):
    """Spiral ``a`` with arms 4 apart and its point reflection about
    (cy + 1, cx + 1), whose arms fall midway between: every pixel of one
    is at least 2 from every pixel of the other."""
    cy, cx = h // 2, w // 2
    a = _spiral(h, w, cy, cx, 4)
    b = [(2 * cy + 2 - y, 2 * cx + 2 - x) for y, x in a]
    weak = np.zeros((h, w), bool)
    for y, x in a + b:
        if 0 <= y < h and 0 <= x < w:
            weak[y, x] = True
    strong = np.zeros((h, w), bool)
    strong[a[-1]] = True
    return strong, weak


def _row_wrap(h, w):
    """Strong and weak pixels that are neighbours only through the
    flattened index: W (r+1, 0)-(r, W-1), NE (r, W-1)-(r, 0), and NW
    (r, 0)-(r-2, W-1)."""
    strong = np.zeros((h, w), bool)
    weak = np.zeros((h, w), bool)
    strong[2, w - 1], weak[3, 0] = True, True
    weak[6, w - 1], strong[7, 0] = True, True
    strong[10, 0], weak[10, w - 1] = True, True
    weak[12, w - 1], strong[14, 0] = True, True
    return strong, weak


def _crease_bands(rng, h, w, bands=12, seeds=3):
    """Weak bands of half-width 1-2 px along random lines (p 0.9 inside),
    weak speckle (p 0.05) elsewhere, a strong pixel on ``seeds`` bands."""
    rr, cc = np.mgrid[0:h, 0:w]
    weak = rng.random((h, w)) < 0.05
    strong = np.zeros((h, w), bool)
    for b in range(bands):
        theta = rng.uniform(0, np.pi)
        y0, x0 = rng.uniform(0, h), rng.uniform(0, w)
        dist = np.abs((rr - y0) * np.cos(theta) - (cc - x0) * np.sin(theta))
        band = dist <= rng.integers(1, 3)
        weak |= band & (rng.random((h, w)) < 0.9)
        if b < seeds:
            on = np.argwhere(band & weak)
            strong[tuple(on[rng.integers(len(on))])] = True
    return strong, weak


def hysteresis_cases(h: int, w: int, seed: int = 0):
    """Every adversarial case at frames of ``h`` x ``w`` (the ragged cases
    use 37x33, 1 x ``w`` and ``h`` x 1)."""
    if h < MIN_H or w < MIN_W:
        raise ValueError(f"hysteresis cases need frames of at least {MIN_H}x{MIN_W}")
    rng = np.random.default_rng(seed)
    one = lambda s, k: (s[None], k[None])
    cases = [
        ("serpentine", *one(*_serpentine(h, w))),
        ("double_spiral", *one(*_double_spiral(h, w))),
    ]
    for p in (0.41, 0.6):
        cases.append((f"percolation_{p}", *random_masks(rng, (1, h, w), p, 0.002)))
    weak = rng.random((1, h, w)) < 0.45
    cases.append(("strong_outside_weak", rng.random((1, h, w)) < 0.02, weak))
    strong = np.zeros((1, h, w), bool)
    strong[0, h // 3, w // 3] = True
    cases.append(("all_weak_one_strong", strong, np.ones((1, h, w), bool)))
    cases.append(("no_strong", np.zeros((1, h, w), bool), rng.random((1, h, w)) < 0.6))
    weak = np.zeros((2, h, w), bool)
    weak[0, h - 1] = True
    weak[0, : h - 1, w // 2] = True
    weak[1, 0] = True
    strong = np.zeros((2, h, w), bool)
    strong[1, 0, w // 2] = True
    cases.append(("frame_edge_leak", strong, weak))
    cases.append(("row_wrap_leak", *one(*_row_wrap(h, w))))
    for name, shape in (("ragged_37x33", (37, 33)), ("ragged_1xW", (1, w)),
                        ("ragged_Hx1", (h, 1))):
        cases.append((name, *random_masks(rng, (2, *shape), 0.6, 0.05)))
    cases.append(("crease_bands", *one(*_crease_bands(rng, h, w))))
    return cases


def hysteresis_truth(strong: np.ndarray, weak: np.ndarray) -> np.ndarray:
    """The components of ``strong | weak`` (8-connected, per frame) that
    hold a strong pixel: ``scipy.ndimage.label``, independent of every
    version under test."""
    from scipy import ndimage

    out = np.zeros(strong.shape, bool)
    for i, (s, wk) in enumerate(zip(strong, weak)):
        labels, _ = ndimage.label(s | wk, structure=np.ones((3, 3), int))
        lit = np.unique(labels[s])
        out[i] = np.isin(labels, lit[lit > 0])
    return out
