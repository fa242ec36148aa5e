"""Adversarial correctness cases for the nearest-neighbour sweep.

A numpy copy of ``rspc_tpu/ops/nn_check.py`` (the cases are
backend-independent; ``tests/test_torch_nn.py`` asserts the two produce
identical arrays). They cover:

  * exact distance ties straddling 1024-wide target chunk boundaries
  * prefix-sparse / suffix-only validity (the kernel's live-target bound)
  * all-invalid target and all-invalid source
  * extreme coordinates (1e6 offsets; and coordinates whose squared
    distances overflow f32 -- contract: those report inf, never garbage)
  * source/target sizes exactly at and just past the tile boundaries

Truth is float64 NumPy brute force; indices may differ only where the
distance is an exact tie. ``chip_smoke.py`` runs every case through the
CUDA sweep on the card.
"""

from __future__ import annotations

import numpy as np

N_CAP = 1024
M_CAP = 4096  # 4 target chunks of 1024


def _case(name, src, tgt, src_valid=None, tgt_valid=None):
    s = np.zeros((N_CAP, 3), np.float32)
    t = np.zeros((M_CAP, 3), np.float32)
    sv = np.zeros(N_CAP, bool)
    tv = np.zeros(M_CAP, bool)
    s[: len(src)] = src
    t[: len(tgt)] = tgt
    sv[: len(src)] = True if src_valid is None else src_valid
    tv[: len(tgt)] = True if tgt_valid is None else tgt_valid
    return name, s, sv, t, tv


def adversarial_cases():
    rng = np.random.default_rng(0)
    cases = []

    # 1. exact ties straddling chunk boundaries: source at origin, two
    # equidistant targets in chunk 0 (idx 100) and chunk 1 (idx 1500)
    tgt = rng.uniform(5, 6, (M_CAP, 3)).astype(np.float32)
    tgt[100] = (1.0, 0.0, 0.0)
    tgt[1500] = (0.0, 1.0, 0.0)  # same squared distance from origin
    tgt[3500] = (0.0, 0.0, 1.0)  # and one in the last chunk
    cases.append(_case("tie_across_chunks", np.zeros((8, 3), np.float32), tgt))

    # 2. prefix-sparse validity: random scattered valid rows
    tgt = rng.uniform(-1, 1, (M_CAP, 3)).astype(np.float32)
    tv = rng.random(M_CAP) < 0.1
    tv[:64] = False
    src = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    cases.append(_case("scattered_validity", src, tgt, tgt_valid=tv[:M_CAP]))

    # 3. suffix-only validity: ONLY the last target row is valid
    # (live_hi == M, full sweep; any off-by-one in the chunk bound loses it)
    tv = np.zeros(M_CAP, bool)
    tv[-1] = True
    cases.append(
        _case("last_row_only", src[:16], tgt, tgt_valid=tv)
    )

    # 4. single valid row in the FIRST chunk (n_chunks should clamp to 1;
    # result must still be exact)
    tv = np.zeros(M_CAP, bool)
    tv[7] = True
    cases.append(_case("first_chunk_only", src[:16], tgt, tgt_valid=tv))

    # 5. all-invalid target -> every distance inf
    cases.append(
        _case("all_invalid_target", src[:32], tgt, tgt_valid=np.zeros(M_CAP, bool))
    )

    # 6. all-invalid source -> inf rows, no NaNs
    cases.append(
        _case(
            "all_invalid_source",
            src[:32],
            tgt,
            src_valid=np.zeros(32, bool),
        )
    )

    # 7. large offset (1e6): recentring must keep mm-scale separations
    base = np.float32([1e6, -2e6, 3e6])
    tgt7 = (rng.uniform(-0.5, 0.5, (M_CAP, 3)) * 0.01 + base).astype(
        np.float32
    )
    src7 = tgt7[:128] + np.float32([0.001, 0, 0])
    cases.append(_case("offset_1e6", src7, tgt7))

    # 8. extreme/garbage coordinates in INVALID rows (the realistic
    # hazard: padding slots hold arbitrary bytes) must not perturb valid
    # results — not via the centroid, the penalty lanes, or NaN
    # propagation through the running min. A VALID source point at 2e19
    # is also included: its true squared distance overflows f32, and the
    # contract is that it reports inf, never finite garbage. (A valid
    # *target* at 2e19 is out of contract: it would poison the shared
    # centroid recentring — f32 geometry is meaningless at that scale.)
    tgt8 = rng.uniform(-1, 1, (M_CAP, 3)).astype(np.float32)
    tv8 = np.ones(M_CAP, bool)
    tgt8[0] = (2e19, 0, 0)
    tgt8[1] = (np.nan, np.nan, np.nan)
    tgt8[2000] = (np.inf, -np.inf, 0)
    tv8[[0, 1, 2000]] = False
    src8 = np.float32([[-2e19, 0, 0], [0.5, 0.5, 0.5], [-0.3, 0.1, 0.9]])
    cases.append(_case("garbage_invalid_rows", src8, tgt8, tgt_valid=tv8))

    # 9. dense full-capacity problem at the exact tile boundary
    tgt9 = rng.uniform(-2, 2, (M_CAP, 3)).astype(np.float32)
    src9 = rng.uniform(-2, 2, (N_CAP, 3)).astype(np.float32)
    cases.append(_case("full_capacity", src9, tgt9))

    return cases


def _truth(src, sv, tgt, tv):
    """float64 brute force; (dist2, idx) with inf where no valid match."""
    d = (
        (src[:, None, :].astype(np.float64) - tgt[None, :, :].astype(np.float64))
        ** 2
    ).sum(-1)
    d[:, ~tv] = np.inf
    idx = d.argmin(1)
    d2 = d[np.arange(len(src)), idx]
    d2[~sv] = np.inf
    d2[~tv.any() * np.ones(len(src), bool)] = np.inf
    return d2, idx


def run_nn_checks(nn_fn, atol=1e-5, rtol=1e-4):
    """Run every adversarial case through ``nn_fn(src, sv, tgt, tv)`` and
    compare against float64 truth. Returns a list of failure strings
    (empty = all pass)."""
    failures = []
    for name, s, sv, t, tv in adversarial_cases():
        d2, idx = nn_fn(s, sv, t, tv)
        d2 = np.asarray(d2)
        idx = np.asarray(idx)
        want_d2, want_idx = _truth(s, sv, t, tv)

        if np.isnan(d2).any():
            failures.append(f"{name}: NaN distances")
            continue
        if not ((idx >= 0) & (idx < M_CAP)).all():
            failures.append(f"{name}: index out of range")
            continue

        inf_want = ~np.isfinite(want_d2)
        # f32 squares may overflow where f64 doesn't; only require inf
        # where even f32 could have represented the distance
        f32_ok = want_d2 < 1e29
        if not (~np.isfinite(d2) | f32_ok)[inf_want & (want_d2 < np.inf)].all():
            pass  # unreachable branch kept for clarity
        if np.isfinite(d2[inf_want]).any():
            failures.append(f"{name}: finite distance where truth is inf")
            continue

        fin = np.isfinite(want_d2) & f32_ok
        if np.isfinite(d2)[fin].all() is False:
            failures.append(f"{name}: inf distance where truth is finite")
            continue
        err = np.abs(d2[fin] - want_d2[fin])
        tol = atol + rtol * np.maximum(want_d2[fin], 1.0)
        if (err > tol).any():
            failures.append(
                f"{name}: dist2 error {err.max():.3e} (tol {tol.min():.1e})"
            )
            continue
        mism = fin & (idx != want_idx)
        if mism.any():
            # allowed only at exact-tie distances
            alt = ((s[mism].astype(np.float64) - t[idx[mism]].astype(np.float64)) ** 2).sum(-1)
            tie_err = np.abs(alt - want_d2[mism])
            if (tie_err > atol + rtol * np.maximum(want_d2[mism], 1.0)).any():
                failures.append(
                    f"{name}: index mismatch beyond ties "
                    f"(worst {tie_err.max():.3e})"
                )
    return failures
