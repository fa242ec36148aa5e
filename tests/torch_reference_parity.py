"""The reference preset (``PipelineConfig()``) on both packages, on the CPU,
at full size: the 10 synthetic 640x480 frames and IMU stream of
``chip_smoke.py`` as a replay recording, through the JAX package's
``get_clouds(CaptureConfig())`` (BGR swizzle, 3/5 crop to 288x384), then
``ICPEdgeBasedRegistration(thetas)`` and ``NDTEdgeBasedRegistration(rads=-0.08)``
in each package on the same clouds.

Per scheme it prints the converged flags, each pair's max |T - T_gt| in
each package, each pair's max |T_jax - T_port| end to end (each package
on its own phase 1), and the same with the JAX package's edge clouds fed
to both packages' ``global_registration`` (the chains alone).

Not a pytest module (the JAX package takes minutes per scheme at this
size on the CPU). Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference_parity.py [icp] [ndt]
"""

import dataclasses
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rspc_tpu.capture.replay import ReplaySource, get_clouds  # noqa: E402
from rspc_tpu.capture.synthetic import SyntheticSequence  # noqa: E402
from rspc_tpu.config import CaptureConfig, PipelineConfig  # noqa: E402
from rspc_tpu.ops.deproject import Intrinsics  # noqa: E402
from rspc_tpu.registration import schemes as js  # noqa: E402
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict  # noqa: E402
from rspc_tpu_torch.registration import schemes as ts  # noqa: E402

N_FRAMES, YAW_STEP = 10, -0.08
SCHEMES = {
    "icp": (js.ICPEdgeBasedRegistration, ts.ICPEdgeBasedRegistration),
    "ndt": (js.NDTEdgeBasedRegistration, ts.NDTEdgeBasedRegistration),
}


def replayed_clouds(seq):
    """The frames and IMU stream as a replay recording (built as
    ``rspc_tpu/cli.py::_source`` builds it), through the capture loop."""
    depth, color = zip(*[(np.asarray(d), np.asarray(c)) for d, c in seq.frames()])
    stream, snap = seq.imu_stream()
    data, stamps = np.asarray(stream.data), np.asarray(stream.ts)
    i = seq.intr
    src = ReplaySource({
        "depth": np.stack(depth), "color": np.stack(color), "ts": stamps[snap],
        "gyro": data[snap - 1], "accel": data[snap],
        "intr": np.asarray([i.width, i.height, i.fx, i.fy, i.ppx, i.ppy], np.float32),
    })
    clouds, thetas = get_clouds(src, N_FRAMES, CaptureConfig())
    return clouds, np.asarray(thetas)


def _np(c, keys=("xyz", "rgb", "valid", "normal")):
    return {k: np.asarray(getattr(c, k)) for k in keys if getattr(c, k) is not None}


def _fmt(xs):
    return "[" + ", ".join(f"{x:.3e}" for x in xs) + "]"


def main(names) -> int:
    seq = SyntheticSequence(n_frames=N_FRAMES, yaw_step=YAW_STEP,
                            intr=Intrinsics.simple(640, 480))
    jclouds, thetas = replayed_clouds(seq)
    frames = [cloud_from_numpy(_np(c, ("xyz", "rgb", "valid")), organized=True)
              for c in jclouds]
    base = PipelineConfig()
    tbase = config_from_dict(dataclasses.asdict(base))
    print(f"{N_FRAMES} replayed clouds of {jclouds[0].height}x{jclouds[0].width}",
          flush=True)

    def pair_max(a, b):
        return np.abs(np.asarray(a) - np.asarray(b)).reshape(N_FRAMES - 1, -1).max(1)

    gt = np.stack([seq.gt_transform(k) for k in range(1, N_FRAMES)])
    for name in names:
        jcls, tcls = SCHEMES[name]
        kw = {"thetas": thetas} if name == "icp" else {"rads": YAW_STEP}
        totals = {}
        for side, cls, cfg, clouds in (("jax", jcls, base, jclouds),
                                       ("port", tcls, tbase, frames)):
            t0 = time.perf_counter()
            scheme = cls(config=cfg, **kw)
            scheme.registration(clouds)
            totals[side] = np.asarray(scheme.total_transforms)
            conv = [bool(f.converged) for _, f in scheme.results]
            print(f"{name} {side} end to end ({time.perf_counter() - t0:.1f} s): converged "
                  f"{sum(conv)}/{len(conv)}; max |T - T_gt| per pair "
                  f"{_fmt(pair_max(totals[side], gt))}", flush=True)
        print(f"{name} end to end: max |T_jax - T_port| per pair "
              f"{_fmt(pair_max(totals['jax'], totals['port']))}", flush=True)

        jscheme = jcls(config=base, **kw)
        feats = jscheme.batch_extract_features(jclouds)
        jscheme.global_registration(
            [(f, js._as_unorganized(c)) for f, c in zip(feats, jclouds)])
        tscheme = tcls(config=tbase, **kw)
        tscheme.global_registration(
            [(cloud_from_numpy(_np(f)), fr.flatten()) for f, fr in zip(feats, frames)])
        conv = ([bool(f.converged) for _, f in jscheme.results],
                [bool(f.converged) for _, f in tscheme.results])
        print(f"{name} on the JAX package's edge clouds: converged flags equal "
              f"{conv[0] == conv[1]}; max |T_jax - T_port| per pair "
              f"{_fmt(pair_max(jscheme.total_transforms, tscheme.total_transforms))}; "
              f"max |T - T_gt| jax {pair_max(jscheme.total_transforms, gt).max():.3e}, "
              f"port {pair_max(tscheme.total_transforms, gt).max():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(SCHEMES)))
