"""The coarse stage's never-worsen guard (port of
``rspc_tpu/registration/pairsteps.py::_guard_best``). The per-pair step
programs, the IMU guesses and the rescue stage are not ported yet
(ROADMAP.md Queue A)."""

from __future__ import annotations

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.ops.transform import apply_transform
from rspc_tpu_torch.registration.measures import _capped_sum, _nn_sweep

# Source-point budget for the guard's hypothesis sweep (same constant as
# the JAX package: a strided 4096-point subsample decides identically).
_GUARD_MAX_POINTS = 4096


def _guard_best(hypotheses, cloud: Cloud, tgt: Cloud, cap, weights=None):
    """The hypothesis transform with the best capped-NN score (earlier
    entries win ties). All hypotheses ride ONE NN sweep: the k transformed
    copies of the source are concatenated into a [kN] problem. The choice
    stays on the device (no host sync)."""
    k = len(hypotheses)
    stacked = torch.cat([apply_transform(t, cloud.xyz) for t in hypotheses], dim=0)
    valid = torch.cat([cloud.valid] * k, dim=0)
    d2, _ = _nn_sweep(stacked, valid, tgt.xyz, tgt.valid)
    scores, _ = _capped_sum(d2.reshape(k, -1), cloud.valid, cap)
    if weights is not None:
        scores = scores * torch.tensor(weights, dtype=scores.dtype,
                                       device=scores.device)
    # index_select keeps the choice on the device (a tensor index would
    # read it back to the host)
    return torch.stack(hypotheses).index_select(0, torch.argmin(scores)[None])[0]
