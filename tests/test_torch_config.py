"""The PyTorch port's configuration and package boundaries, against the JAX
package: config defaults field by field, the launch-XML loader, the
device rule (``cuda`` unless asked, never a silent CPU fallback) and the
rule that the port imports neither ``jax`` nor ``autorally_tpu``."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from autorally_tpu import config as jcfg
from autorally_tpu_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["MPPIConfig", "CostParams"])
def test_config_defaults_match_field_by_field(name):
    jax_cls, port_cls = getattr(jcfg, name), getattr(tcfg, name)
    j_fields = [f.name for f in dataclasses.fields(jax_cls)]
    t_fields = [f.name for f in dataclasses.fields(port_cls)]
    assert t_fields == j_fields
    j, t = jax_cls(), port_cls()
    for f in j_fields:
        assert getattr(t, f) == getattr(j, f), f


def test_config_properties_replace_and_gamma():
    j = jcfg.MPPIConfig(max_throttle=0.5, hz=40)
    t = tcfg.MPPIConfig(max_throttle=0.5, hz=40)
    for prop in ("dt", "exploration_std", "init_u", "control_ranges"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.replace(num_rollouts=64).num_rollouts == 64
    cp = tcfg.CostParams()
    assert tcfg.effective_gamma(t, cp) == t.gamma
    assert tcfg.effective_gamma(t, cp.replace(gamma=0.3)) == 0.3
    assert os.path.basename(tcfg.REFERENCE_NN_NPZ) == os.path.basename(
        jcfg.REFERENCE_NN_NPZ)


def test_launch_params_loader_matches(tmp_path, monkeypatch):
    xml = tmp_path / "mppi.launch"
    xml.write_text(
        '<launch><node name="mppi_controller" pkg="autorally_control" '
        'type="path_integral_nn">'
        '<param name="hz" value="40" type="int"/>'
        '<param name="gamma" value="0.2" type="double"/>'
        '<param name="l1_cost" value="true" type="bool"/>'
        '<param name="desired_speed" value="$(env SPEED)"/>'
        '<param name="track_coefficient" value="150"/>'
        '</node></launch>')
    monkeypatch.setenv("SPEED", "7.5")
    pj = jcfg.load_launch_params(str(xml))
    pt = tcfg.load_launch_params(str(xml))
    assert pt == pj
    (cj, kj), (ct, kt) = jcfg.config_from_params(pj), tcfg.config_from_params(pt)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    for f in ("desired_speed", "track_coeff", "speed_coeff"):
        assert getattr(kt, f) == float(getattr(kj, f))


def test_cuda_request_without_gpu_raises(monkeypatch):
    """Default and explicit CUDA requests raise when no GPU is present —
    the port never quietly runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no GPU"):
            tcfg.resolve_device(dev)
    assert tcfg.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_reference_package():
    """Import every module of the port in a fresh interpreter and check
    that neither jax nor any autorally_tpu module came along."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import autorally_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'autorally_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'autorally_tpu' "
        "or m.startswith('autorally_tpu.'))\n"
        "assert len(names) >= 12, names\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("BAD []"), out.stdout
