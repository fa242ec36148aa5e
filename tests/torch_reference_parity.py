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

With ``robust``, it runs instead the robust presets on their scenes of
the robustness matrix (``benchmarks/robustness.py``, seed 0, 10 frames):
``robust_config(anchor_mode="map")`` on ``partial_overlap``,
``color=True`` on ``combined`` and ``pose_graph=True`` (skips {1, 2, 3}
and the closures, IMU thetas) on ``loop_drift``, or ``scene:preset``
with a preset of ``map``, ``color``, ``graph`` or ``auto``
(``auto_register``), at 640x480 unless
``--size=WxH`` says otherwise, the JAX package on the CPU and the port on
``--device`` (the CPU unless given), printing each package's converged
count and max |T - T_gt| beside the matrix's record, and max |T_jax -
T_port| end to end. With ``--edges=port`` the scene is rendered as
``chip_smoke.py`` renders it (the port's renderer on ``--device``), and
the JAX package registers the port's CPU edge clouds beside the port's
own run (the chains compared on shared edges). The JAX package
takes ten to fifteen minutes per scene at 640x480 on the CPU.

With ``canny``, it counts frame 0's RGB Canny edge pixels of a scene by
the JAX package's jitted program, by the same evaluated op by op, and by
the port, and how many pixels of each differ from the jitted edges.

With ``phase1``, it renders each scene as ``chip_smoke.py`` does (on
``--device``) and counts, per frame, the edge pixels of the JAX package's
jitted phase 1 (``batch_extract_features`` under the scene's robust
preset, on the CPU) and of the port's on ``--device``, and how many each
has that the other lacks. With ``split``, it runs a scene's robust preset
in the port on ``--device`` alone and prints, per pair, the rescue gate
(fired, inliers), the fine stage's inliers, and the chain's and the final
max |T - T_gt|: run it on the card and on the CPU to find the first pair
where the two part.

With ``serving``, it runs the serving phase's sequences of
``chip_smoke.py`` (``benchmarks/serving.py``: 10 frames, yaw -0.08 -
0.01 i rad per frame, ``north_star_config()``, static accumulated-yaw
guesses, no global cloud; i = 0..3 unless yaws are given), one at a
time through each package's ``batched_registration`` at B = 1, the JAX
package on the CPU and the port on ``--device``, on the JAX package's
frames, and prints each package's converged count and max |T - T_gt|
per pair, and max |T_jax - T_port|.

With ``ndt_modes``, it runs the north star (``NDTEdgeBasedRegistration(
rads=-0.08, config=north_star_config())``, 10 frames at 640x480 unless
``--size=WxH``) in each package with NDT's line search frozen (the
default), PCL-exact (``pcl_exact_line_search``) and with the compact-cell
sweep (``sweep_cells=512``), the JAX package on the CPU and the port on
``--device``, each on its own renders of the same scene, and prints
each run's converged count, max |T - T_gt| and wall, each mode's max
|T - T_frozen| within its package, and max |T_jax - T_port| per mode.
With ``--jax-edges`` the port registers the JAX package's frames, and its
phase 1 returns the JAX package's edge clouds (a monkeypatch of
``registration/chainscan.py::extract_edge_features_batch``, as
tests/test_torch_edge_schemes.py swaps them), so that the two chains
are compared alone.

Not a pytest module (the JAX package takes minutes per scheme at this
size on the CPU). Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference_parity.py [icp] [ndt]
    JAX_PLATFORMS=cpu python tests/torch_reference_parity.py canny [--size=WxH] [scene]
    JAX_PLATFORMS=cpu python tests/torch_reference_parity.py robust [--size=WxH] \
        [--device=cuda] [--edges=port] [scene[:preset] ...]
    JAX_PLATFORMS=cpu python tests/torch_reference_parity.py phase1 [--size=WxH] [--device=cuda] [scene ...]
    JAX_PLATFORMS=cpu python tests/torch_reference_parity.py split [--size=WxH] [--device=cuda] scene
    JAX_PLATFORMS=cpu python tests/torch_reference_parity.py serving [--size=WxH] [--device=cuda] [yaw ...]
    JAX_PLATFORMS=cpu python tests/torch_reference_parity.py ndt_modes [--size=WxH] \
        [--device=cuda] [--jax-edges]
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
from rspc_tpu_torch.interop import (  # noqa: E402
    cloud_from_numpy,
    cloud_to_numpy,
    config_from_dict,
)
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


# the robust presets by name, and each scene's preset with the matrix's
# record of max |T - T_gt| (benchmarks/records_matrix_r5_seed0.jsonl)
PRESETS = {"map": {"anchor_mode": "map"},
           "color": {"anchor_mode": "map", "color": True},
           "graph": {"anchor_mode": "map", "pose_graph": True}}
ROBUST = {"partial_overlap": ("map", 3.636e-3), "combined": ("color", 5.210e-2),
          "loop_drift": ("graph", 1.753e-2)}
RECORDS = {("partial_overlap", "map"): 3.636e-3, ("combined", "color"): 5.210e-2,
           ("combined", "map"): 1.200e-1, ("loop_drift", "graph"): 1.753e-2,
           ("loop_drift", "map"): 1.936e-2}


def robust(args) -> int:
    """``robust [--size=WxH] [--device=cuda] [scene[:preset] ...]``: the
    port runs on ``--device`` (the CPU by default), the JAX package on
    the CPU."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks"))
    from robustness import scenarios

    from rspc_tpu.presets import robust_config

    opts = dict(a[2:].split("=", 1) for a in args if a.startswith("--"))
    width, height = (int(x) for x in opts.get("size", "640x480").split("x"))
    device = opts.get("device", "cpu")
    names = [a for a in args if not a.startswith("--")] or list(ROBUST)
    for item in names:
        name, _, preset = item.partition(":")
        preset = preset or ROBUST[name][0]
        record = RECORDS.get((name, preset), float("nan"))
        skw = dict(scenarios()[name][0])
        yaw = skw.pop("yaw_step", YAW_STEP)
        seq = SyntheticSequence(n_frames=N_FRAMES, yaw_step=yaw, seed=0,
                                intr=Intrinsics.simple(width, height), **skw)
        jclouds = seq.clouds()
        frames = [cloud_from_numpy(_np(c, ("xyz", "rgb", "valid")), organized=True,
                                   device=device) for c in jclouds]
        cfg = robust_config(**PRESETS.get(preset, {}))
        guess = {"rads": yaw}
        if "yaw_schedule" in skw:
            yaws = skw["yaw_schedule"]
            closure = {j - i for i in range(N_FRAMES) for j in range(i + 1, N_FRAMES)
                       if abs(yaws[i] - yaws[j]) < 1e-9}
            cfg = dataclasses.replace(cfg, refine=dataclasses.replace(
                cfg.refine, pose_graph_skips=tuple(sorted({1, 2, 3} | closure))))
            guess = {"thetas": np.asarray(seq.thetas())}
        gt = np.stack([seq.gt_transform(k) for k in range(1, N_FRAMES)])
        if preset == "auto":
            auto(name, width, height, device, jclouds, frames, guess, gt)
            continue
        if opts.get("edges") == "port":
            port_edges(name, preset, device, cfg, record)
            continue
        totals = {}
        for side, cls, c, clouds in (
                ("jax", js.NDTEdgeBasedRegistration, cfg, jclouds),
                (f"port ({device})", ts.NDTEdgeBasedRegistration,
                 config_from_dict(dataclasses.asdict(cfg)), frames)):
            t0 = time.perf_counter()
            scheme = cls(config=c, **guess)
            scheme.registration(clouds)
            t = scheme.total_transforms
            totals[side] = np.asarray(t.cpu() if hasattr(t, "cpu") else t)
            conv = [bool(f.converged) for _, f in scheme.results]
            print(f"{name} {preset} {width}x{height} {side} ({time.perf_counter() - t0:.1f} s): "
                  f"converged {sum(conv)}/{len(conv)}; max |T - T_gt| "
                  f"{np.abs(totals[side] - gt).max():.4e} (record {record:.4e}); per pair "
                  f"{_fmt(pair_max(totals[side], gt))}", flush=True)
        a, b = totals.values()
        print(f"{name} {preset}: max |T_jax - T_port| {np.abs(a - b).max():.4e}", flush=True)
    return 0


def port_edges(name, preset, device, cfg, record):
    """The scene as ``chip_smoke.py`` renders it (the port's renderer on
    ``device``, 640x480); the port end to end on ``device``, and the JAX
    package's chain and anchors on the port's CPU edge clouds (which
    round the Canny gradients as the JAX package's jitted program does,
    and differ from its edges in a few tens of pixels per frame)."""
    import chip_smoke
    from rspc_tpu.cloud import Cloud as JCloud
    from rspc_tpu.cloud import OrganizedCloud as JOrganized
    from rspc_tpu_torch.ops.edges import extract_edge_features_batch

    seq, clouds, guess, skips = chip_smoke.scenario(name, device)
    if cfg.refine.pose_graph:
        cfg = dataclasses.replace(cfg, refine=dataclasses.replace(
            cfg.refine, pose_graph_skips=skips))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    gt = np.stack([seq.gt_transform(k) for k in range(1, N_FRAMES)])
    frames = [{k: getattr(c, k).cpu().numpy() for k in ("xyz", "rgb", "valid")}
              for c in clouds]
    feats, _, _ = extract_edge_features_batch(
        [cloud_from_numpy(f, organized=True) for f in frames], tcfg.edge)
    port = ts.NDTEdgeBasedRegistration(config=tcfg, **guess)
    port.registration(clouds)
    t0 = time.perf_counter()
    jguess = {k: np.asarray(v) for k, v in guess.items()}
    jscheme = js.NDTEdgeBasedRegistration(config=cfg, **jguess)
    jclouds = [JOrganized(**{k: jax.numpy.asarray(v) for k, v in f.items()}) for f in frames]
    jscheme.batch_extract_features(jclouds)  # the refine clouds
    jscheme.global_registration(
        [(JCloud(**{k: jax.numpy.asarray(v) for k, v in cloud_to_numpy(f).items()}), c.flatten())
         for f, c in zip(feats, jclouds)])
    for side, t in ((f"port ({device}) end to end", port.total_transforms.cpu()),
                    ("jax on the port's edge clouds", jscheme.total_transforms)):
        print(f"{name} {preset} {side}: max |T - T_gt| {np.abs(np.asarray(t) - gt).max():.4e} "
              f"(record {record:.4e}); per pair {_fmt(pair_max(t, gt))}", flush=True)
    print(f"{name} {preset}: jax took {time.perf_counter() - t0:.0f} s", flush=True)


def _scene_preset(name):
    """The robust preset ``chip_smoke.py`` runs on a scene (JAX package's)."""
    from rspc_tpu.presets import robust_config

    return robust_config(**PRESETS[ROBUST.get(name, ("map",))[0]])


def phase1(args) -> int:
    """``phase1 [--size=WxH] [--device=cuda] [scene ...]``: per frame, the edge pixels
    (as xyz rows) of each package's phase 1 on the same frames."""
    import chip_smoke
    from rspc_tpu.cloud import OrganizedCloud as JOrganized
    from rspc_tpu_torch.ops.edges import extract_edge_features_batch

    opts = dict(a[2:].split("=", 1) for a in args if a.startswith("--"))
    device = opts.get("device", "cpu")
    if "size" in opts:
        chip_smoke.WIDTH, chip_smoke.HEIGHT = (int(x) for x in opts["size"].split("x"))
    for name in [a for a in args if not a.startswith("--")] or list(ROBUST):
        _, clouds, _, _ = chip_smoke.scenario(name, device)
        cfg = _scene_preset(name)
        feats, _, _ = extract_edge_features_batch(
            clouds, config_from_dict(dataclasses.asdict(cfg)).edge)
        jfeats = js.NDTEdgeBasedRegistration(config=cfg, rads=0.0).batch_extract_features(
            [JOrganized(**{k: jax.numpy.asarray(getattr(c, k).cpu().numpy())
                           for k in ("xyz", "rgb", "valid")}) for c in clouds])
        for i, (t, j) in enumerate(zip(feats, jfeats)):
            tset = {tuple(r) for r in t.xyz[t.valid].cpu().numpy().tolist()}
            jset = {tuple(r) for r in np.asarray(j.xyz)[np.asarray(j.valid)].tolist()}
            print(f"{name} frame {i}: edge pixels jax {len(jset)}, port ({device}) "
                  f"{len(tset)}; only jax {len(jset - tset)}, only port {len(tset - jset)}",
                  flush=True)
    return 0


def split(args) -> int:
    """``split [--size=WxH] [--device=cuda] scene``: the port's robust preset on one
    scene, per pair: the rescue gate, the fine inliers, the chain's and
    the final errors."""
    import chip_smoke
    from rspc_tpu_torch.cloud import OrganizedCloud
    from rspc_tpu_torch.registration import pairsteps

    opts = dict(a[2:].split("=", 1) for a in args if a.startswith("--"))
    device = opts.get("device", "cpu")
    if "size" in opts:
        chip_smoke.WIDTH, chip_smoke.HEIGHT = (int(x) for x in opts["size"].split("x"))
    name = next(a for a in args if not a.startswith("--"))
    seq, clouds, guess, skips = chip_smoke.scenario(name, device)
    clouds = [OrganizedCloud(xyz=c.xyz, rgb=c.rgb, valid=c.valid) for c in clouds]
    cfg = _scene_preset(name)
    if cfg.refine.pose_graph:
        cfg = dataclasses.replace(cfg, refine=dataclasses.replace(
            cfg.refine, pose_graph_skips=skips))
    gates, chain = [], {}
    rescue_from, chain_scan = pairsteps._rescue_from, ts._chain_scan

    def spied_rescue(cur, target, n_inl, *a, **kw):
        rel, need = rescue_from(cur, target, n_inl, *a, **kw)
        gates.append((bool(need), int(n_inl)))
        return rel, need

    def spied_chain(*a, **kw):
        chain.update(chain_scan(*a, **kw))
        return chain

    pairsteps._rescue_from, ts._chain_scan = spied_rescue, spied_chain
    try:
        t0 = time.perf_counter()
        scheme = ts.NDTEdgeBasedRegistration(
            config=config_from_dict(dataclasses.asdict(cfg)), **guess)
        scheme.registration(clouds)
    finally:
        pairsteps._rescue_from, ts._chain_scan = rescue_from, chain_scan
    gt = np.stack([seq.gt_transform(k) for k in range(1, N_FRAMES)])
    final = scheme.total_transforms.cpu()
    print(f"{name} port ({device}, {time.perf_counter() - t0:.0f} s): rescue (fired, "
          f"inliers) {gates}; fine inliers {[int(f.n_correspondences) for f in chain['fine']]}; "
          f"chain {_fmt(pair_max(chain['totals'].cpu(), gt))}; final "
          f"{_fmt(pair_max(final, gt))}, max {np.abs(np.asarray(final) - gt).max():.4e}",
          flush=True)
    return 0


def auto(name, width, height, device, jclouds, frames, guess, gt):
    """``auto_register`` in both packages: selection, scores, errors."""
    from rspc_tpu.registration.auto import auto_register as j_auto
    from rspc_tpu_torch.registration.auto import auto_register as t_auto

    for side, fn, clouds in (("jax", j_auto, jclouds), (f"port ({device})", t_auto, frames)):
        t0 = time.perf_counter()
        ar = fn(clouds, **guess)
        t = ar.total_transforms
        t = np.asarray(t.cpu() if hasattr(t, "cpu") else t)
        conv = [bool(f.converged) for _, f in ar.scheme.results]
        print(f"{name} auto {width}x{height} {side} ({time.perf_counter() - t0:.1f} s): "
              f"selected {ar.selected}, escalated {ar.escalated}, scores {ar.scores}; "
              f"converged {sum(conv)}/{len(conv)}; max |T - T_gt| {np.abs(t - gt).max():.4e}",
              flush=True)


def serving(args) -> int:
    """``serving [--size=WxH] [--device=cuda] [yaw ...]``."""
    import jax.numpy as jnp
    import torch

    from rspc_tpu.cloud import OrganizedCloud as JOrganized
    from rspc_tpu.parallel.chain import batched_registration as j_batched
    from rspc_tpu.presets import north_star_config as j_north_star
    from rspc_tpu_torch.parallel import batched_registration as t_batched
    from rspc_tpu_torch.presets import north_star_config as t_north_star

    opts = dict(a[2:].split("=", 1) for a in args if a.startswith("--"))
    width, height = (int(x) for x in opts.get("size", "640x480").split("x"))
    device = opts.get("device", "cpu")
    yaws = [float(a) for a in args if not a.startswith("--")] or [
        YAW_STEP - 0.01 * i for i in range(4)]
    for yaw in yaws:
        seq = SyntheticSequence(n_frames=N_FRAMES, yaw_step=yaw,
                                intr=Intrinsics.simple(width, height))
        jclouds = seq.clouds()
        guesses, acc = [], 0.0
        for _ in range(N_FRAMES - 1):  # benchmarks/serving.py's accumulation
            acc += yaw
            m = np.eye(4, dtype=np.float32)
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = np.cos(acc), np.sin(acc), -np.sin(acc), np.cos(acc)
            guesses.append(m)
        guesses = np.stack(guesses)[None]
        fields = {k: np.stack([np.asarray(getattr(c, k)) for c in jclouds])[None]
                  for k in ("xyz", "rgb", "valid")}
        gt = np.stack([seq.gt_transform(k) for k in range(1, N_FRAMES)])
        totals = {}
        for side, run in (
                ("jax", lambda: j_batched(JOrganized(**{k: jnp.asarray(v) for k, v in
                                                        fields.items()}),
                                          jnp.asarray(guesses), j_north_star(),
                                          use_ndt=True, include_global=False)),
                (f"port ({device})", lambda: t_batched(
                    cloud_from_numpy(fields, organized=True, device=device),
                    torch.from_numpy(guesses).to(device), t_north_star(), use_ndt=True,
                    include_global=False))):
            t0 = time.perf_counter()
            out = run()
            host = lambda x: np.asarray(x.cpu() if hasattr(x, "cpu") else x)
            totals[side] = host(out["totals"][0])
            conv = int(host(out["converged"][0]).sum())
            print(f"serving yaw {yaw:+.2f} {width}x{height} {side} "
                  f"({time.perf_counter() - t0:.1f} s): converged {conv}/{N_FRAMES - 1}; "
                  f"max |T - T_gt| {pair_max(totals[side], gt).max():.4e}; per pair "
                  f"{_fmt(pair_max(totals[side], gt))}", flush=True)
        a, b = totals.values()
        print(f"serving yaw {yaw:+.2f}: max |T_jax - T_port| {np.abs(a - b).max():.4e}",
              flush=True)
    return 0


def ndt_modes(args) -> int:
    """``ndt_modes [--size=WxH] [--device=cuda] [--jax-edges]``."""
    import contextlib
    from unittest import mock

    from rspc_tpu.presets import north_star_config as j_north_star
    from rspc_tpu_torch.capture.synthetic import SyntheticSequence as TSequence
    from rspc_tpu_torch.ops.deproject import Intrinsics as TIntrinsics
    from rspc_tpu_torch.presets import north_star_config as t_north_star
    from rspc_tpu_torch.registration import chainscan as tchain

    opts = dict((a[2:].split("=", 1) + [""])[:2] for a in args if a.startswith("--"))
    width, height = (int(x) for x in opts.get("size", "640x480").split("x"))
    device = opts.get("device", "cpu")
    seq = SyntheticSequence(n_frames=N_FRAMES, yaw_step=YAW_STEP,
                            intr=Intrinsics.simple(width, height))
    gt = np.stack([seq.gt_transform(k) for k in range(1, N_FRAMES)])
    jclouds = seq.clouds()
    swap = contextlib.nullcontext()
    if "jax-edges" in opts:
        feats = js.NDTEdgeBasedRegistration(
            rads=YAW_STEP, config=j_north_star()).batch_extract_features(jclouds)
        port_clouds = [cloud_from_numpy(_np(c, ("xyz", "rgb", "valid")), organized=True,
                                        device=device) for c in jclouds]
        real = tchain.extract_edge_features_batch

        def jax_edges(frames, cfg):
            _, normals, n_valid = real(frames, cfg)
            return [cloud_from_numpy(_np(f), device=device) for f in feats], normals, n_valid

        swap = mock.patch.object(tchain, "extract_edge_features_batch", jax_edges)
        print("ndt_modes: the port's phase 1 returns the JAX package's edge clouds", flush=True)
    else:
        port_clouds = TSequence(n_frames=N_FRAMES, yaw_step=YAW_STEP,
                                intr=TIntrinsics.simple(width, height)).clouds(device=device)
    sides = {
        "jax": (js.NDTEdgeBasedRegistration, j_north_star(), jclouds),
        f"port ({device})": (ts.NDTEdgeBasedRegistration, t_north_star(), port_clouds),
    }
    modes = {"frozen": {}, "exact": {"pcl_exact_line_search": True},
             "sweep": {"sweep_cells": 512}}
    totals = {}
    for side, (cls, base, clouds) in sides.items():
        for mode, kw in modes.items():
            cfg = dataclasses.replace(base, ndt=dataclasses.replace(base.ndt, **kw))
            t0 = time.perf_counter()
            scheme = cls(rads=YAW_STEP, config=cfg)
            with swap if side != "jax" else contextlib.nullcontext():
                scheme.registration(clouds)
            t = scheme.total_transforms
            totals[side, mode] = np.asarray(t.cpu() if hasattr(t, "cpu") else t)
            conv = [bool(f.converged) for _, f in scheme.results]
            print(f"ndt_modes {side} {mode} {width}x{height} ({time.perf_counter() - t0:.1f} s):"
                  f" converged {sum(conv)}/{len(conv)}; max |T - T_gt| "
                  f"{pair_max(totals[side, mode], gt).max():.4e}; per pair "
                  f"{_fmt(pair_max(totals[side, mode], gt))}", flush=True)
        for mode in ("exact", "sweep"):
            print(f"ndt_modes {side}: {mode} against frozen, max |T - T_frozen| "
                  f"{np.abs(totals[side, mode] - totals[side, 'frozen']).max():.4e}", flush=True)
    jax_side, port_side = sides
    for mode in modes:
        print(f"ndt_modes {mode}: max |T_jax - T_port| "
              f"{np.abs(totals[jax_side, mode] - totals[port_side, mode]).max():.4e}",
              flush=True)
    return 0


def pair_max(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).reshape(N_FRAMES - 1, -1).max(1)


def canny(args) -> int:
    """``canny [--size=WxH] [scene]``: frame 0's RGB Canny edges (inside
    the valid pixels) by the JAX package's jitted program, by the same
    evaluated op by op (``jax.disable_jit``), and by the port."""
    import importlib

    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks"))
    from robustness import scenarios

    from rspc_tpu.config import EdgeConfig
    from rspc_tpu_torch.config import EdgeConfig as TEdgeConfig
    from rspc_tpu_torch.ops.canny import _hysteresis
    from rspc_tpu_torch.ops.edges import _rgb_masks

    jcanny = importlib.import_module("rspc_tpu.ops.canny")
    opts = dict(a[2:].split("=", 1) for a in args if a.startswith("--"))
    width, height = (int(x) for x in opts.get("size", "640x480").split("x"))
    name = next((a for a in args if not a.startswith("--")), "partial_overlap")
    skw = dict(scenarios()[name][0])
    yaw = skw.pop("yaw_step", YAW_STEP)
    c = SyntheticSequence(n_frames=1, yaw_step=yaw, seed=0,
                          intr=Intrinsics.simple(width, height), **skw).clouds()[0]
    cfg = EdgeConfig(edge_types=("rgb_canny",))
    lo, hi = cfg.canny_low_threshold, cfg.canny_high_threshold
    intensity = jax.jit(lambda rgb: jnp.mean(rgb, axis=-1))(c.rgb)
    jit_e = np.asarray(jax.jit(lambda i: jcanny.canny(i, lo, hi))(intensity))
    with jax.disable_jit():
        op_e = np.asarray(jcanny.canny(intensity, lo, hi))
    strong, weak = _rgb_masks(cloud_from_numpy(_np(c, ("xyz", "rgb", "valid")), organized=True),
                              TEdgeConfig(edge_types=("rgb_canny",)))
    port_e = _hysteresis(strong[None], weak[None])[0].numpy()
    v = np.asarray(c.valid)
    print(f"{name} frame 0 at {width}x{height}: edge pixels jitted {(jit_e & v).sum()}, "
          f"op by op {(op_e & v).sum()}, port {(port_e & v).sum()}; differing from the jitted "
          f"edges: op by op {((op_e != jit_e) & v).sum()}, port {((port_e != jit_e) & v).sum()}",
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["canny"]:
        sys.exit(canny(sys.argv[2:]))
    if sys.argv[1:2] == ["robust"]:
        sys.exit(robust(sys.argv[2:]))
    if sys.argv[1:2] == ["phase1"]:
        sys.exit(phase1(sys.argv[2:]))
    if sys.argv[1:2] == ["serving"]:
        sys.exit(serving(sys.argv[2:]))
    if sys.argv[1:2] == ["ndt_modes"]:
        sys.exit(ndt_modes(sys.argv[2:]))
    if sys.argv[1:2] == ["split"]:
        sys.exit(split(sys.argv[2:]))
    sys.exit(main(sys.argv[1:] or list(SCHEMES)))
