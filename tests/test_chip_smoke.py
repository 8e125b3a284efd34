"""chip_smoke.py's helpers (CPU), and its parity phase (on a GPU only)."""

import json

import jax
import numpy as np
import pytest

import chip_smoke
from rust_particle_system.ops.grid import SPHQuantities


def test_last_line_is_the_exact_contract():
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1
    assert "\n" not in line


@pytest.mark.parametrize("delta,ok", [(0.0, True), (0.9e-4, True), (3e-4, False)])
def test_compare_applies_rtol_and_scaled_atol(delta, ok):
    want = np.asarray([1000.0, -2.0, 0.0])
    got = want + delta * np.asarray([1000.0, 0.0, 0.0])
    rec = chip_smoke.compare("f", got, want)
    assert rec["ok"] is ok
    assert rec["scale"] == 1000.0


def test_compare_atol_scales_with_the_field():
    want = np.asarray([1000.0, 0.0])
    # 0.009 absolute error on a zero entry: inside atol = 1e-5 x 1000.
    assert chip_smoke.compare("f", want + [0.0, 0.009], want)["ok"]
    assert not chip_smoke.compare("f", want + [0.0, 0.011], want)["ok"]


@pytest.mark.parametrize("got", [np.asarray([1.0, np.nan]), np.asarray([1.0]),
                                 np.asarray([1.0, np.inf])])
def test_compare_rejects_non_finite_and_shape_mismatch(got):
    assert not chip_smoke.compare("f", got, np.asarray([1.0, 2.0]))["ok"]


def test_compare_quantities_covers_six_fields():
    rng = np.random.default_rng(0)
    q = SPHQuantities(rng.random(5), rng.random(5), rng.random((5, 2)),
                      rng.random((5, 2)))
    recs = chip_smoke.compare_quantities("x", q, q)
    assert [r["field"] for r in recs] == ["rho", "rhon", "fpx", "fvx", "fpy", "fvy"]
    assert all(r["ok"] and r["label"] == "x" for r in recs)
    bad = q._replace(fv=q.fv * 1.01)
    assert not all(r["ok"] for r in chip_smoke.compare_quantities("x", bad, q))


def test_smoke_phase_records_failure_and_report_raises(capsys):
    sm = chip_smoke.Smoke()
    sm.phase("boom", lambda: sm.check(False, "nope"))
    sm.phase("fine", lambda: None)
    assert sm.failed == ["boom"]
    out = capsys.readouterr().out
    assert "FAILED phase boom" in out
    with pytest.raises(AssertionError, match="parity outside tolerance"):
        sm.report([dict(chip_smoke.compare("f", [2.0], [1.0]), label="l")])


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: runs on the card as chip_smoke.py's kernel_parity "
                    "phase")
    return dev


@pytest.mark.gpu
def test_kernel_parity_phase_on_the_card(gpu):
    sm = chip_smoke.Smoke()
    sm.kind, sm.card = gpu.device_kind, chip_smoke.card_info()
    chip_smoke.phase_parity(sm)
