"""The port's scale-out layer (``rspc_tpu_torch/parallel/``) against the
JAX package's (``rspc_tpu/parallel/``), on the CPU over gloo.

One module fixture renders the inputs with the JAX package (the 80x60
frames, the NDT cases' grids; ``torch_parallel_jax.py``), then starts 4
gloo ranks once, each a process running ``torch_parallel_worker.py
... port`` (``file://`` init in a temporary directory; the worker
imports neither jax nor ``rspc_tpu``). They build ``make_mesh(4)``
(``data`` x ``points`` = 2 x 2), ``make_mesh(4, axes=("points",))`` and
a 4 x 1 mesh (``points`` groups of one rank), run every path on them and
the single-rank references, and pickle their results. While they run,
the JAX package computes its side live on the same inputs: the sharded
NN on its 8 virtual CPU devices and single-device, sharded and single
NDT, single-device ICP. Its sharded ICP and chains take about 110 s to
compile on the CPU, so tests/test_torch_parallel_jax.py holds the port
against them, on its own xdist worker; this file stays under a minute.

Tolerances:
  * every rank holds the same bits of every collective result;
  * the sharded NN equals the port's unsharded sweep exactly (distances
    and indices), and the JAX package's sharded and single sweeps as the
    port's single sweep does (tests/test_torch_nn.py): the same indices
    for valid sources, the same inf pattern, distances rtol 1e-5;
  * against the JAX package, the port's single-rank tolerance of the same
    function (``W.JAX_TOL``): ICP and NDT transforms 1e-4
    (tests/test_torch_voxel_icp_ndt.py), NDT scores rtol 1e-4;
  * against the port's own single rank, 10x the JAX package's
    sharded-against-single figure in MULTICHIP_r05.json (``W.SINGLE_TOL``):
    p2p ICP 2.64e-6, p2l and colored ICP 1.82e-6, NDT 1.92e-6 (with NDT
    scores rtol 1e-4), the points-sharded chain 5.36e-6. Both NDT cases
    (tests/test_parallel.py's points in a cube, the dry run's wall and
    floor) take the same Newton path sharded and single: every NDT value
    is one reduction of the same sum (tests/test_torch_ndt_parity.py);
  * NDT's two optional modes (the PCL-exact line search, the compact-cell
    sweep) on the dry run's case, sharded over a 2-rank group, against
    the port's single rank: transform ``W.SINGLE_TOL["ndt"]``, score rtol
    1e-4, iterations within +-1;
  * bit for bit: a world-size-1 group against ``group=None`` (ICP, NDT,
    the fits, the whole chain), the data-sharded batch against the
    unsharded one, and the unsharded batch against one ``_registration_fused``
    per sequence through the scheme's own fused path.
"""

import numpy as np
import pytest
import torch

import torch_parallel_jax as J
import torch_parallel_worker as W
from rspc_tpu.parallel import make_mesh as j_make_mesh
from rspc_tpu_torch.cloud import OrganizedCloud
from rspc_tpu_torch.interop import config_from_dict
from rspc_tpu_torch.parallel import batched_registration
from rspc_tpu_torch.parallel.mesh import mesh_shape

from torch_parallel_worker import JAX_TOL, SINGLE_TOL, assert_same, max_err

RANK_TIMEOUT_S = 240
COLLECTIVE = (["mesh shapes"]
              + [f"nn {c} {m}" for c in ("all_valid", "masked") for m in ("points4", "2x2")]
              + [f"icp {c} {m}" for c in W.ICP_CFG for m in ("points4", "2x2")]
              + [f"batched icp {v} 2x2" for v in ("p2p", "p2l")]
              + [f"ndt {c} {m}" for c in W.NDT_CFG for m in ("points4", "2x2")]
              + [f"ndt {mode} wall_floor 2x2" for mode in W.NDT_MODES]
              + [f"points chain {m}" for m in ("points4", "2x2", "4x1")]
              + [f"batched 2x2 global={g}" for g in (True, False)]
              + ["batched errors"])


@pytest.fixture(scope="module")
def inputs():
    """The JAX package's frames and NDT grids, made live."""
    return J.inputs(edges=False)


@pytest.fixture(scope="module")
def both(tmp_path_factory, inputs):
    """(each rank's ``{job: result}`` from one run of 4 gloo ranks, the
    JAX package's results), the JAX side computed while the ranks run."""
    started = W.start(tmp_path_factory.mktemp("gloo"), inputs, "port", RANK_TIMEOUT_S)
    try:
        jax_side = {**J.nn_results(), **J.ndt_results(), **J.icp_single_results()}
    finally:
        ranks = W.collect(started)
    return ranks, jax_side


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_side(both):
    return both[1]


@pytest.mark.parametrize("job", COLLECTIVE)
def test_every_rank_holds_the_same_result(ranks, job):
    for r in range(1, W.WORLD):
        assert_same(ranks[r][job], ranks[0][job])


def test_make_mesh_shapes(ranks):
    shapes = ranks[0]["mesh shapes"]
    j4, j4p = j_make_mesh(4), j_make_mesh(4, axes=("points",))
    assert shapes["2x2"] == dict(j4.shape) == {"data": 2, "points": 2}
    assert shapes["points4"] == dict(j4p.shape) == {"points": 4}
    for n in range(1, 9):  # the JAX package's factoring on its 8 devices
        assert mesh_shape(n, 2) == tuple(j_make_mesh(n).shape.values())
        assert mesh_shape(n, 1) == tuple(j_make_mesh(n, axes=("points",)).shape.values())


def test_make_mesh_needs_the_callers_process_group():
    """make_mesh starts no process group of its own choosing."""
    from rspc_tpu_torch.parallel import make_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device_type="cpu")


@pytest.mark.parametrize("case", ["all_valid", "masked"])
@pytest.mark.parametrize("mesh", ["points4", "2x2"])
def test_sharded_nn_is_exact(ranks, jax_side, case, mesh):
    d2, idx = ranks[0][f"nn {case} {mesh}"]
    single_d2, single_idx = ranks[2][f"nn {case} single"]
    np.testing.assert_array_equal(idx, single_idx)
    np.testing.assert_array_equal(d2, single_d2)
    sv = W.nn_case(case)[1]
    for which in ("sharded", "single"):
        want_d2 = jax_side[f"nn/{case}/{which}/d2"]
        np.testing.assert_array_equal(idx[sv], jax_side[f"nn/{case}/{which}/idx"][sv])
        np.testing.assert_array_equal(np.isfinite(d2), np.isfinite(want_d2))
        fin = np.isfinite(want_d2)
        np.testing.assert_allclose(d2[fin], want_d2[fin], rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("case", list(W.ICP_CFG))
@pytest.mark.parametrize("mesh", ["points4", "2x2"])
def test_sharded_icp(ranks, jax_side, case, mesh):
    """Against the port's single rank and the JAX package's single device
    (its sharded solve: tests/test_torch_parallel_jax.py)."""
    got = ranks[0][f"icp {case} {mesh}"]
    assert max_err(got["transform"], jax_side[f"icp/{case}/single/transform"]) <= JAX_TOL["icp"]
    assert bool(got["converged"]) == bool(jax_side[f"icp/{case}/single/converged"])
    single = ranks[2][f"icp {case} none"]
    assert max_err(got["transform"], single["transform"]) <= SINGLE_TOL[case]
    assert bool(got["converged"]) and bool(single["converged"])
    # fitness at a near-exact fit is f32 noise (~1e-14): an absolute bound
    np.testing.assert_allclose(got["fitness"], jax_side[f"icp/{case}/single/fitness"],
                               rtol=1e-3, atol=1e-10)


@pytest.mark.parametrize("variant", ["p2p", "p2l"])
def test_batched_sharded_icp(ranks, variant):
    """Each pair against the port's single rank (the JAX package's batch:
    tests/test_torch_parallel_jax.py)."""
    got = ranks[0][f"batched icp {variant} 2x2"]
    assert got["transform"].shape == (2, 4, 4)
    assert got["converged"].all()
    for i in range(2):
        single = ranks[2][f"batched icp {variant} single {i}"]
        assert max_err(got["transform"][i], single["transform"]) <= SINGLE_TOL[variant]


@pytest.mark.parametrize("case", list(W.NDT_CFG))
@pytest.mark.parametrize("mesh", ["points4", "2x2"])
def test_sharded_ndt(ranks, jax_side, case, mesh):
    got = ranks[0][f"ndt {case} {mesh}"]
    for which in ("sharded", "single"):
        assert max_err(got["transform"], jax_side[f"ndt/{case}/{which}/transform"]) <= JAX_TOL["ndt"]
    np.testing.assert_allclose(got["score"], jax_side[f"ndt/{case}/sharded/score"], rtol=1e-4)
    single = ranks[3][f"ndt {case} none"]
    assert max_err(got["transform"], single["transform"]) <= SINGLE_TOL["ndt"]
    np.testing.assert_allclose(got["score"], single["score"], rtol=1e-4)


@pytest.mark.parametrize("mode", list(W.NDT_MODES))
def test_sharded_ndt_modes(ranks, mode):
    """The PCL-exact line search and the compact-cell sweep with
    ``group``, sharded over the 2 x 2 mesh's 2-rank points groups,
    against one rank with ``group=None``."""
    got = ranks[0][f"ndt {mode} wall_floor 2x2"]
    single = ranks[3][f"ndt {mode} wall_floor none"]
    assert max_err(got["transform"], single["transform"]) <= SINGLE_TOL["ndt"]
    np.testing.assert_allclose(got["score"], single["score"], rtol=1e-4)
    assert abs(int(got["iterations"]) - int(single["iterations"])) <= 1


@pytest.mark.parametrize("job,rank", [
    *((f"icp {c}", 2) for c in W.ICP_CFG), *((f"ndt {c}", 3) for c in W.NDT_CFG),
    ("fits", 3), ("fused robust", 1)])
def test_group_of_one_rank_is_group_none_bit_for_bit(ranks, job, rank):
    assert_same(ranks[rank][f"{job} one"], ranks[rank][f"{job} none"])


@pytest.mark.parametrize("mesh", ["points4", "2x2", "4x1"])
def test_points_sharded_chain(ranks, mesh):
    """The robust chain (warm start, guard, rescue, map anchor) with every
    pair solve sharded; the 4 x 1 mesh's group of one rank gives the
    single-rank bits."""
    got = ranks[0][f"points chain {mesh}"]
    single = ranks[1]["fused robust none"]
    if mesh == "4x1":
        np.testing.assert_array_equal(got["totals"], single["totals"])
    assert max_err(got["totals"], single["totals"]) <= SINGLE_TOL["chain"]
    np.testing.assert_array_equal(got["converged"], single["converged"])
    np.testing.assert_array_equal(got["anchor_accepted"], single["anchor_accepted"])
    assert "global" not in got


@pytest.mark.parametrize("include_global", [True, False])
def test_data_sharded_batch_equals_unsharded(ranks, include_global):
    got = ranks[0][f"batched 2x2 global={include_global}"]
    assert_same(got, ranks[0][f"batched none global={include_global}"])
    assert ("global" in got) == include_global


def test_unsharded_batch_is_the_schemes_fused_path(ranks, inputs):
    """Sequence 0 of the batch through ``NDTEdgeBasedRegistration`` (its
    fused path calls the same body): the same totals bit for bit."""
    from rspc_tpu_torch.registration.schemes import NDTEdgeBasedRegistration

    frames = [OrganizedCloud(*(torch.from_numpy(inputs[f"frames_{k}"][0, i])
                               for k in ("xyz", "rgb", "valid")))
              for i in range(W.N_FRAMES)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' setting: the same reduction order
    try:
        scheme = NDTEdgeBasedRegistration(rads=W.YAWS[0],
                                          config=config_from_dict(W.CHAIN_CFG))
        scheme.registration(frames)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(scheme.total_transforms.numpy(),
                                  ranks[0]["batched none global=True"]["totals"][0])


def test_batched_shape_errors(ranks, inputs):
    stacked = OrganizedCloud(*(torch.from_numpy(inputs[f"frames_{k}"])
                               for k in ("xyz", "rgb", "valid")))
    guesses = torch.from_numpy(np.stack([W.static_guesses(y) for y in W.YAWS]))
    cfg = config_from_dict(W.CHAIN_CFG)
    with pytest.raises(ValueError, match="sequence batch"):
        batched_registration(stacked.map(lambda x: x[0]), guesses, cfg)
    with pytest.raises(ValueError, match="guesses"):
        batched_registration(stacked, guesses[:, :1], cfg)
    divisible, data_axis, axis = ranks[0]["batched errors"]
    assert "not divisible by data axis 4" in divisible
    assert "mesh needs a 'data' axis" in data_axis
    assert "mesh needs a 'rows' axis" in axis
