"""The port's configuration and import hygiene.

Every config dataclass default of ``rspc_tpu_torch.config`` (a copy, so
the port never imports jax) must equal ``rspc_tpu.config``'s, and the
port's presets must equal the JAX package's. Importing every port module
must leave jax and ``rspc_tpu`` out of ``sys.modules``: checked in a
subprocess, because this test session already imports jax."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import rspc_tpu.config as jcfg
import rspc_tpu_torch.config as tcfg
from rspc_tpu.presets import north_star_config as j_north_star
from rspc_tpu.presets import robust_config as j_robust
from rspc_tpu_torch.interop import config_from_dict
from rspc_tpu_torch.presets import north_star_config as t_north_star
from rspc_tpu_torch.presets import robust_config as t_robust


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLASSES = [
    name for name, obj in vars(jcfg).items()
    if dataclasses.is_dataclass(obj) and isinstance(obj, type)
]


def test_same_config_classes():
    port = {
        name for name, obj in vars(tcfg).items()
        if dataclasses.is_dataclass(obj) and isinstance(obj, type)
    }
    assert port == set(_CLASSES)


@pytest.mark.parametrize("name", _CLASSES)
def test_every_default_equal(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = {f.name: f for f in dataclasses.fields(j)}
    tf = {f.name: f for f in dataclasses.fields(t)}
    assert list(jf) == list(tf)
    # instances compare field by field, nested configs included
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())


def test_north_star_preset_equal():
    assert dataclasses.asdict(j_north_star()) == dataclasses.asdict(t_north_star())


# every combination the auto ladder and the CLI build (and the defaults)
ROBUST_KW = [
    {},
    {"anchor_mode": "map"},
    {"anchor_mode": "map", "color": True},
    {"anchor_mode": "map", "pose_graph": True},
    {"anchor_mode": "first", "pose_graph": True, "color": True, "color_weight": 0.5},
]


@pytest.mark.parametrize("kw", ROBUST_KW, ids=lambda kw: ",".join(kw) or "default")
def test_robust_preset_equal(kw):
    assert dataclasses.asdict(j_robust(**kw)) == dataclasses.asdict(t_robust(**kw))
    assert config_from_dict(dataclasses.asdict(j_robust(**kw))) == t_robust(**kw)


def test_config_from_dict_roundtrip():
    cfg = j_north_star()
    port = config_from_dict(dataclasses.asdict(cfg))
    assert isinstance(port, tcfg.PipelineConfig)
    assert port == t_north_star()
    assert isinstance(port.refine.anchor_stages[0], tcfg.ICPConfig)


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import rspc_tpu_torch\n"
        "for m in pkgutil.walk_packages(rspc_tpu_torch.__path__, 'rspc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'rspc_tpu' or k.startswith('rspc_tpu.'))\n"
        "print(len([k for k in sys.modules if k.startswith('rspc_tpu_torch')]))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported
