"""The port's controller-state checkpoints (``io/checkpoint.py``) against
the JAX package's on the CPU: a ``.npz`` written by either package loads
into the other field for field (the key as its two uint32 words), for one
state and for a tube pair given as an async tube, a ``Controller`` pair or
raw states; and a sequential controller resumes from its checkpoint bit
for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorally_tpu.io import checkpoint as jckpt
from autorally_tpu.solver.mppi import ControllerState as JaxState
from autorally_tpu_torch.io import checkpoint as ckpt
from autorally_tpu_torch.runtime.controller import Controller
from autorally_tpu_torch.solver.mppi import ControllerState
from test_torch_async_loop import START, _build


def _random_state(seed: int, T: int = 16) -> ControllerState:
    g = torch.Generator().manual_seed(seed)
    return ControllerState(
        U=torch.randn(T, 2, generator=g),
        control_hist=torch.randn(2, 2, generator=g),
        state_solution=torch.randn(T, 7, generator=g),
        control_solution=torch.randn(T, 2, generator=g),
        key=np.array([seed, 0xFFFFFFF0 + seed], np.uint32))


def _same(ours: ControllerState, theirs) -> None:
    assert ControllerState._fields == JaxState._fields
    for f in ControllerState._fields:
        a, b = getattr(ours, f), np.asarray(getattr(theirs, f))
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_a_state_written_by_either_package_loads_into_the_other(tmp_path):
    cs = _random_state(3)
    ckpt.save_controller_state(cs, str(tmp_path / "port.npz"))
    _same(cs, jckpt.load_controller_state(str(tmp_path / "port.npz")))
    jcs = JaxState(*(jnp.asarray(getattr(cs, f).numpy())
                     for f in ControllerState._fields[:-1]),
                   key=jax.random.PRNGKey(11))
    jckpt.save_controller_state(jcs, str(tmp_path / "jax.npz"))
    back = ckpt.load_controller_state(str(tmp_path / "jax.npz"),
                                      device="cpu")
    _same(back, jcs)
    assert back.key.dtype == np.uint32 and list(back.key) == [0, 11]


def test_tube_pairs_round_trip_between_the_packages(tmp_path):
    tube, plant, _ = _build()
    tube.reset(START)
    tube.dispatch(START, 0).result()
    a, p = _random_state(1), _random_state(2)
    for i, pair in enumerate((tube, (a, p))):
        path = str(tmp_path / f"tube{i}.npz")
        ckpt.save_tube_state(pair, path)
        ja, jp = jckpt.load_tube_state(path)
        want = ckpt._tube_pair(pair)
        _same(want[0], ja)
        _same(want[1], jp)
        jpath = str(tmp_path / f"jax{i}.npz")
        jckpt.save_tube_state((ja, jp), jpath)
        for got, w in zip(ckpt.load_tube_state(jpath, device="cpu"), want):
            _same(got, w)


def test_controller_resumes_bit_for_bit(tmp_path):
    tube, plant, _ = _build()
    s = tube.solver
    ctrls = [Controller(s, tube.model_params, tube.cost_params, tube.costmap,
                        seed=n) for n in (0, 5, 0, 5)]
    for c in ctrls[:2]:
        c.set_state(START)
        c.compute_control(START)
    path = str(tmp_path / "pair.npz")
    ckpt.save_tube_state(ctrls[:2], path)
    ctrls[2].cs, ctrls[3].cs = ckpt.load_tube_state(path, device="cpu")
    for old, new in zip(ctrls[:2], ctrls[2:]):
        old.compute_control(START)
        new.compute_control(START)
        np.testing.assert_array_equal(old.get_control_seq(),
                                      new.get_control_seq())
        assert np.array_equal(old.cs.key, new.cs.key)


def test_load_defaults_to_cuda_and_raises_without_gpu(tmp_path, monkeypatch):
    path = str(tmp_path / "cs.npz")
    ckpt.save_controller_state(_random_state(0), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        ckpt.load_controller_state(path)
