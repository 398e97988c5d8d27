"""The port's diagnostics (``runtime/diagnostics.py``) against the JAX
package's: the two diagnostics tests of ``tests/test_observability.py``, each
script run on both packages and their rollups compared."""

from autorally_tpu.runtime import diagnostics as jdiag
from autorally_tpu_torch.runtime import diagnostics


def _worst_level_script(mod):
    agg = mod.DiagnosticsAggregator(publish_hz=1000.0)
    chassis = agg.component("chassis")
    gps = agg.component("gps")
    chassis.diag_ok("serial", "connected")
    chassis.tick("wheelSpeeds data")
    chassis.tick("wheelSpeeds data")
    gps.diag_warn("fix", "float RTK")
    first = agg.maybe_publish(now=1.0)
    gps.diag_error("fix", "no fix")
    second = agg.maybe_publish(now=3.0)
    return first, second, agg.history


def test_diagnostics_worst_level_rollup():
    first, second, history = _worst_level_script(diagnostics)
    assert first["level"] == "warn"
    assert first["components"]["chassis"]["ticks"]["wheelSpeeds data"] == 2
    assert second["level"] == "error"
    assert second["components"]["chassis"]["ticks"] == {}
    assert history == [first, second]
    assert (first, second, history) == _worst_level_script(jdiag)


def _rate_script(mod):
    agg = mod.DiagnosticsAggregator(publish_hz=1.0)
    agg.component("x").diag_ok("k")
    return [agg.maybe_publish(now=t) for t in (10.0, 10.5, 11.1)]


def test_diagnostics_publish_rate_limited():
    reports = _rate_script(diagnostics)
    assert reports[0] is not None and reports[1] is None
    assert reports[2] is not None
    assert reports == _rate_script(jdiag)


def test_diagnostics_levels_and_callback_equal_jax():
    """The level constants, a component's level, registration, ``diag``
    with an explicit stamp and the publish callback, on both packages."""
    out = []
    for mod in (diagnostics, jdiag):
        got = []
        agg = mod.DiagnosticsAggregator(publish_hz=2.0, on_publish=got.append)
        d = agg.register(mod.Diagnostics("runstop", hardware_id="box0"))
        assert agg.component("runstop") is d and d.hardware_id == "box0"
        assert d.level == mod.OK
        d.diag("state", "GREEN", mod.WARN, now=5.0)
        assert d.entries["state"].stamp == 5.0 and d.level == mod.WARN
        d.diag_error("link", "no data")
        assert d.level == mod.ERROR
        agg.maybe_publish(now=100.0)
        out.append((mod.OK, mod.WARN, mod.ERROR, got))
    assert out[0] == out[1]
    assert out[0][3][0]["components"]["runstop"]["level"] == "error"
