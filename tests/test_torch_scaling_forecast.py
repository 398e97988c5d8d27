"""The port's scaling forecast (``tools/scaling_forecast.py``): its payload
is the bytes the port's sharded iteration reduces, its probe runs the
iteration's collectives on two gloo CPU ranks through ``parallel/launch``,
and its document keeps ``tests/test_artifacts.py``'s schema with the GPU
fabrics in place of the TPU's."""

import json
import math

import pytest
import torch

from autorally_tpu_torch.config import CostParams, MPPIConfig
from autorally_tpu_torch.costs import MPPICost
from autorally_tpu_torch.models import NeuralNetDynamics
from autorally_tpu_torch.parallel import ShardedMPPISolver
from autorally_tpu_torch.tools import scaling_forecast as sf

FABRIC_KEYS = ("nvlink", "infiniband")


def _is_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and math.isfinite(x)


def validate_scaling(d: dict) -> None:
    """``tests/test_artifacts.py``'s ``validate_scaling``, the fabric keys
    renamed."""
    assert d["artifact"] == "scaling_forecast"
    assert _is_num(d["payload_bytes"])
    assert _is_num(d["fit"]["chain_floor_ms"])
    assert _is_num(d["fit"]["ms_per_rollout"])
    assert isinstance(d["forecast"], dict) and d["forecast"]
    for per_k in d["forecast"].values():
        for fab in FABRIC_KEYS:
            assert isinstance(per_k[fab], list) and per_k[fab]
            for r in per_k[fab]:
                assert _is_num(r["efficiency"]) and _is_num(r["t_n_ms"])
    v = d["validation"]
    assert isinstance(v["measured_per_iter_us"], dict)
    assert _is_num(v["max_shape_rel_err"])


def test_payload_is_what_the_sharded_iteration_reduces():
    """Count the elements ``_combine`` hands to its MIN and SUM."""
    cfg = MPPIConfig(num_rollouts=64, num_timesteps=100)
    solver = ShardedMPPISolver(NeuralNetDynamics(0.02, device="cpu"),
                               MPPICost(), cfg, device="cpu")
    seen = []

    def op(x):
        seen.append(x.numel() * x.element_size())
        return x

    solver._shard_ops = lambda: (op, op)
    total = torch.rand(64)
    solver._combine(CostParams(), total, torch.zeros(64, dtype=torch.bool),
                    lambda w: torch.zeros(100, 2))
    assert sum(seen) == sf.PAYLOAD_BYTES == 820
    assert len(seen) == 2


def test_forecast_document_without_probe(capsys):
    doc = sf.main(["--skip-probe", "--ns", "2,4,8"])
    assert json.loads(capsys.readouterr().out.strip()) == doc
    assert set(doc["assumptions"]) == set(FABRIC_KEYS)
    assert doc["ladder_ms"] == {"1920": 0.1932, "8192": 0.3292,
                                "262144": 3.9414}
    for per_k in doc["forecast"].values():
        for fab in FABRIC_KEYS:
            assert [r["n"] for r in per_k[fab]] == [2, 4, 8]
            assert per_k[f"{fab}_max_n_at_85pct"] in (0, 2, 4, 8)
    # the chain floor dominates small K: scaling it out gains little
    k1920 = doc["forecast"]["K1920"]["nvlink"]
    assert k1920[-1]["efficiency"] < 0.5
    assert "validation" not in doc


def test_probe_on_two_gloo_ranks_and_the_schema(capsys):
    doc = sf.main(["--iters", "3", "--Ks", "1920,262144", "--ns", "2,4"])
    capsys.readouterr()
    validate_scaling(doc)
    measured = doc["validation"]["measured_per_iter_us"]
    assert sorted(map(int, measured)) == [4 * p for p in sf.PROBE_PADS]
    assert all(v > 0 for v in measured.values())
    # 4 MB a step costs more than 4 B
    assert measured[str(4 * sf.PROBE_PADS[-1])] > measured["4"]


def test_probe_rank_results_come_from_both_ranks():
    from autorally_tpu_torch.parallel import launch

    res = launch.run(sf.probe_rank, 2, (2,), backend="gloo", device="cpu",
                     timeout=120.0)
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["nproc"] == 2 and r["iters"] == 2 for r in res)
    assert set(res[0]["per_iter_s"]) == {str(4 * p) for p in sf.PROBE_PADS}


@pytest.mark.parametrize("ladder", [{1920: 0.2, 65536: 2.0},
                                    {1: 0.1, 2: 0.1, 3: 0.1}])
def test_fit_ladder_recovers_a_line(ladder):
    a, b = sf.fit_ladder(ladder)
    for k, ms in ladder.items():
        assert a + b * k == pytest.approx(ms, rel=1e-6)
