"""The port's cost-parameter sweep (``tools/param_sweep.py``) against the
JAX tool on the CPU: the grid and the stacking; ``run_sweep`` against the
JAX ``run_sweep`` through its vmapped Pallas kernels (``use_pallas_rollout
=True``, ``_pallas_interpret=True``), lane by lane; each lane against the
port's solo episode with that lane's ``CostParams``; the twins of
``tests/test_param_sweep.py`` on seeded weights, whose outcome is held
against the JAX run on the same weights (its speed bounds belong to the
reference weights); and ``main``'s lines against the JAX tool's.

Both packages take seeded weights (``params_from_jax``) and each solve's
noise from one table, picked by its subkey, as
``tests/test_torch_episode.py`` injects it: the JAX sweep's controller
states enter its vmap unbatched, so every lane draws the same noise, as
the port's lanes share each solve's draw.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autorally_tpu.config as jax_config
import autorally_tpu.io.compile_cache as jax_compile_cache
import autorally_tpu.ops.sampling as jax_sampling
from autorally_tpu.config import CostParams as JaxCostParams
from autorally_tpu.config import MPPIConfig as JaxConfig
from autorally_tpu.costs import MPPICost as JaxCost
from autorally_tpu.costs.costmap import make_costmap as jax_make_costmap
from autorally_tpu.models import NeuralNetDynamics as JaxNN
from autorally_tpu.runtime.episode import EpisodeRunner as JaxRunner
from autorally_tpu.solver.mppi import MPPISolver as JaxSolver
from autorally_tpu.tools import param_sweep as jsweep
from autorally_tpu_torch.config import (CostParams, MPPIConfig,
                                        lane_cost_params)
from autorally_tpu_torch.costs import MPPICost, make_costmap
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.runtime.episode import EpisodeResult, EpisodeRunner
from autorally_tpu_torch.solver import mppi as port_mppi
from autorally_tpu_torch.solver.mppi import MPPISolver
from autorally_tpu_torch.tools import param_sweep as sweep

K, T, TICKS = 128, 16, 24
NOISE_TABLE = 16
START = np.array([30.0, 0.0, math.pi / 2, 0, 0, 0, 0], dtype=np.float32)
# tests/test_torch_episode.py's map of one cost: a texel edge of a real
# map turns a rounding difference of a rollout's position into a jump of
# its cost, which no tolerance of a closed loop absorbs
FLAT = np.zeros((60, 80, 4), np.float32)
FLAT[..., 0] = 0.1                     # under the 0.65 boundary: no crash
FLAT_MAP = (FLAT, (-40.0, 40.0), (-30.0, 30.0))
# tests/test_torch_episode.py's tolerances (the same solves, plant steps
# and arbitration as its episodes): states and executed controls within
# 1e-4 relative / 1e-6 absolute, the chosen solve's trajectory cost, ESS
# and gamma within 1e-5 relative (the first two scaled by gamma / 0.15
# above 0.15), the arbitration and the crash fraction equal.
TOLS = {"states": (1e-4, 1e-6), "controls": (1e-4, 1e-6),
        "trajectory_cost": (1e-5, 0.0), "ess": (1e-5, 0.0),
        "crash_frac": (0.0, 0.0), "gamma": (1e-5, 0.0)}
GAMMA_SCALED = ("trajectory_cost", "ess")
# A lane against the port's solo episode: the solves are bit for bit the
# solo ones on the CPU, but the plant steps all lanes in one batched MLP,
# whose (L, 32) x (32, 32) products sum in another order than the solo
# plant's vector-matrix ones; the ulps that leaves grow through the loop.
LANE_RTOL, LANE_ATOL = 1e-5, 1e-5


def _table():
    rs = np.random.default_rng(11)
    return rs.standard_normal((NOISE_TABLE, T, K, 2)).astype(np.float32)


def _inject(solver, jsolver, table):
    """Each solve's noise picked by its subkey from ``table`` (the port's
    generator is seeded with the subkey's words, the JAX sampler gets the
    subkey)."""
    jtable = jnp.asarray(table)
    solver._sample_noise = lambda gen, shape: torch.tensor(
        table[(gen.initial_seed() & 0xFFFFFFFF) % NOISE_TABLE])
    jsolver._sample_noise = lambda key, shape: jtable[key[1] % NOISE_TABLE]


class Rig:
    """Both packages' runners on the map of one cost, seeded 6-32-32-4
    weights, the JAX solver forced onto its Pallas kernels in interpret
    mode."""

    def __init__(self):
        cfg = MPPIConfig(num_rollouts=K, num_timesteps=T)
        jcfg = JaxConfig(num_rollouts=K, num_timesteps=T,
                         use_pallas_rollout=True)
        self.cm = make_costmap(*FLAT_MAP, device="cpu")
        self.jcm = jax_make_costmap(*FLAT_MAP)
        jmodel = JaxNN(jcfg.dt, control_ranges=jcfg.control_ranges)
        self.jparams = jmodel.init_params(jax.random.PRNGKey(0))
        model = NeuralNetDynamics(cfg.dt, control_ranges=cfg.control_ranges,
                                  device="cpu")
        self.params = model.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jparams))
        solver = MPPISolver(model, MPPICost(), cfg, device="cpu")
        jsolver = JaxSolver(jmodel, JaxCost(), jcfg)
        assert jsolver.use_pallas_rollout
        jsolver._pallas_interpret = True
        _inject(solver, jsolver, _table())
        self.runner = EpisodeRunner(solver, n_ticks=TICKS)
        self.jrunner = JaxRunner(jsolver, n_ticks=TICKS)
        self.runs = {}

    def sweep(self, grid):
        """(the port's result, the JAX result as numpy), run once a grid."""
        key = json.dumps(grid)
        if key not in self.runs:
            ours = sweep.run_sweep(self.runner, self.params,
                                   sweep.stack_cost_params(CostParams(),
                                                           grid),
                                   self.cm, START)
            ref = jsweep.run_sweep(self.jrunner, self.jparams,
                                   jsweep.stack_cost_params(JaxCostParams(),
                                                            grid),
                                   self.jcm, START)
            self.runs[key] = ours, jax.tree_util.tree_map(np.asarray, ref)
        return self.runs[key]


@pytest.fixture(scope="module")
def rig():
    return Rig()


def test_build_grid_cartesian_product():
    sweeps = {"a": [1.0, 2.0], "b": [10.0, 20.0, 30.0]}
    grid = sweep.build_grid(sweeps)
    assert grid == jsweep.build_grid(sweeps)
    assert len(grid) == 6
    assert {"a": 1.0, "b": 30.0} in grid
    assert all(set(pt) == {"a", "b"} for pt in grid)


def test_stack_cost_params_lane_axis():
    grid = [{"desired_speed": 4.0}, {"desired_speed": 6.0}]
    stacked = sweep.stack_cost_params(CostParams(), grid)
    ref = jsweep.stack_cost_params(JaxCostParams(), grid)
    assert stacked.desired_speed.shape == (2,)
    assert stacked.desired_speed.dtype == torch.float32
    np.testing.assert_allclose(stacked.desired_speed.numpy(), [4.0, 6.0])
    # non-swept fields replicate the base value down the lane axis, and a
    # field None in every point stays None
    assert stacked.crash_coeff.shape == (2,)
    np.testing.assert_allclose(stacked.crash_coeff.numpy(),
                               [10000.0, 10000.0])
    assert stacked.gamma is None and stacked.obstacles is None
    for f in ("desired_speed", "speed_coeff", "track_coeff", "max_slip_ang",
              "slip_penalty", "track_slop", "crash_coeff", "steering_coeff",
              "throttle_coeff", "boundary_threshold", "discount"):
        np.testing.assert_array_equal(getattr(stacked, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    lanes = lane_cost_params(stacked)
    assert [cp.desired_speed for cp in lanes] == [4.0, 6.0]
    assert lanes[1].discount == float(np.float32(0.1))


@pytest.mark.parametrize("grid", [
    [{"desired_speed": 3.0}, {"desired_speed": 5.0}],
    [{"gamma": 0.05}, {"gamma": 0.15}, {"gamma": 0.6}],
], ids=["desired_speed", "gamma"])
def test_sweep_matches_jax_pallas_lane_by_lane(rig, grid):
    """Lane by lane, every field of the port's sweep against the JAX
    sweep through its vmapped Pallas kernels (interpret mode)."""
    ours, ref = rig.sweep(grid)
    for field in EpisodeResult._fields:
        a, b = getattr(ours, field).numpy(), getattr(ref, field)
        assert a.shape == b.shape == (len(grid), TICKS) + b.shape[2:], field
        for lane in range(len(grid)):
            if field == "used_actual":
                np.testing.assert_array_equal(a[lane], b[lane], field)
                continue
            rtol, atol = TOLS[field]
            if field in GAMMA_SCALED:
                rtol *= max(1.0, float(b[lane].max()) / 0.15)
            np.testing.assert_allclose(a[lane], b[lane], rtol=rtol,
                                       atol=atol, err_msg=f"{field} {lane}")
    assert np.isfinite(ours.states.numpy()).all()


def test_sweep_lane_matches_solo_episode(rig):
    """Lane l of the sweep against the port's solo episode with lane l's
    CostParams (``LANE_RTOL``: the plant's batched MLP)."""
    grid = [{"desired_speed": 3.0}, {"desired_speed": 5.0}]
    ours, _ = rig.sweep(grid)
    stacked = sweep.stack_cost_params(CostParams(), grid)
    for lane, cp in enumerate(lane_cost_params(stacked)):
        solo = rig.runner.run(rig.params, cp, rig.cm, START)
        for field in EpisodeResult._fields:
            a, b = getattr(ours, field)[lane], getattr(solo, field)
            if field in ("used_actual", "crash_frac", "gamma"):
                assert torch.equal(a, b), field
            else:
                torch.testing.assert_close(a, b, rtol=LANE_RTOL,
                                           atol=LANE_ATOL, msg=field)


def test_sweep_parameters_steer_the_outcome(rig):
    """A higher desired speed drives the closed loop faster in the JAX
    run on these weights, and in the port's, by as much (the seeded
    model hardly moves the car: its mean speeds are ~1e-4 m/s, which the
    rows round to 0, so they are compared before the rounding)."""
    grid = [{"desired_speed": 2.0}, {"desired_speed": 5.0}]
    ours, ref = rig.sweep(grid)
    settle = TICKS // 4
    rows = sweep.lane_metrics(ours, grid, settle=settle)
    jrows = jsweep.lane_metrics(ref, grid, settle=settle)
    assert all(np.isfinite(r["score"]) for r in rows)
    speed = ours.states.numpy()[:, settle:, 4].mean(axis=1)
    jspeed = ref.states[:, settle:, 4].mean(axis=1)
    assert speed[1] > speed[0] and jspeed[1] > jspeed[0]
    np.testing.assert_allclose(speed, jspeed, rtol=1e-4)
    for r, j in zip(rows, jrows):
        assert set(r) == set(j)
        for name in ("mean_speed", "max_speed", "distance_m", "crash_pct",
                     "mean_ess", "score"):
            assert r[name] == pytest.approx(j[name], rel=1e-3, abs=0.11), name


def test_gamma_is_sweepable(rig):
    """The stacked gamma makes the softmax temperature a sweepable
    parameter: the per-lane ESS falls as gamma rises, in the port as in
    the JAX run, and the lanes drive different plans."""
    grid = [{"gamma": 0.05}, {"gamma": 0.15}, {"gamma": 0.6}]
    ours, ref = rig.sweep(grid)
    ess = ours.ess.numpy().mean(axis=1)
    jess = ref.ess.mean(axis=1)
    assert ess[0] > ess[1] > ess[2], f"ESS not monotone in gamma: {ess}"
    np.testing.assert_array_equal(np.argsort(ess), np.argsort(jess))
    np.testing.assert_allclose(ess, jess, rtol=1e-4)
    np.testing.assert_array_equal(ours.gamma.numpy()[:, 0],
                                  np.float32([0.05, 0.15, 0.6]))
    states = ours.states.numpy()
    assert not np.allclose(states[0], states[2])


SMALL = ["--ticks", "8", "--rollouts", str(K), "--timesteps", str(T),
         "--sweep", "desired_speed=3,5"]


def test_main_prints_the_jax_tools_lines(monkeypatch, capsys, tmp_path):
    """``main`` on a seeded ``.npz`` (``MODEL_NPZ``), both tools' noise
    from one table: the JAX tool's lines (a JSON row a grid point, best
    first, then ``BEST``), values within the rounding of the rows."""
    npz = str(tmp_path / "seeded.npz")
    JaxNN(0.02).save_params(JaxNN(0.02).init_params(jax.random.PRNGKey(3)),
                            npz)
    table = _table()
    jtable = jnp.asarray(table)
    monkeypatch.setattr(sweep, "MODEL_NPZ", npz)
    monkeypatch.setattr(port_mppi, "make_sampler", lambda *a: (
        lambda gen, shape: torch.tensor(
            table[(gen.initial_seed() & 0xFFFFFFFF) % NOISE_TABLE])))
    monkeypatch.setattr(jax_sampling, "make_sampler", lambda *a: (
        lambda key, shape: jtable[key[1] % NOISE_TABLE]))
    monkeypatch.setattr(jax_config, "REFERENCE_NN_NPZ", npz)
    monkeypatch.setattr(jax_compile_cache, "enable_persistent_cache",
                        lambda *a, **k: None)
    out_json = tmp_path / "out.json"
    assert sweep.main(SMALL + ["--cpu", "--out", str(out_json)]) == 0
    ours = capsys.readouterr().out.strip().splitlines()
    jsweep.main(SMALL + ["--cpu"])
    ref = capsys.readouterr().out.strip().splitlines()
    assert len(ours) == len(ref) == 3
    assert ours[-1].startswith("BEST ") and ref[-1].startswith("BEST ")
    rows = [json.loads(line.removeprefix("BEST ")) for line in ours]
    jrows = [json.loads(line.removeprefix("BEST ")) for line in ref]
    for r, j in zip(rows, jrows):
        assert list(r) == list(j)
        for name, v in j.items():
            assert r[name] == pytest.approx(v, rel=1e-3, abs=0.11), name
    saved = json.loads(out_json.read_text())
    assert saved["best"] == rows[-1] and len(saved["grid"]) == 2


def test_missing_weights_raise(monkeypatch, tmp_path):
    missing = str(tmp_path / "absent.npz")
    monkeypatch.setattr(sweep, "MODEL_NPZ", missing)
    with pytest.raises(FileNotFoundError, match="absent.npz"):
        sweep.main(SMALL + ["--cpu"])
