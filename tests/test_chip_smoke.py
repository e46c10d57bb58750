"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to
run without a GPU.  On the card the script runs them at full width."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chip_smoke as cs

TINY = cs.Sizes(bos_dots=6, bos_points=4, bos_rays=8, sensor=64, field_n=12,
                piv_particles=40, piv_rays=8, big_n=132, exact_dots=6,
                exact_rays=16)


def test_smoke_bos_gradient_and_tube_parity(tmp_path, capsys):
    checks = cs.Checks()
    sc, img = cs.phase_bos(TINY, str(tmp_path), checks)
    cs.phase_bos_grad(sc, img, checks)
    cs.parity_tube_dense(sc, checks)
    out = capsys.readouterr().out
    assert not checks.failed, out
    assert "[smoke] bos forward" in out and "compile" in out
    assert "[smoke] bos invert_bos 3 steps" in out


def test_smoke_piv(tmp_path):
    checks = cs.Checks()
    cs.phase_piv(TINY, str(tmp_path), checks)
    assert not checks.failed


def test_smoke_large_volume_through_tube_march(tmp_path):
    checks = cs.Checks()
    sc, _ = cs.phase_bos(TINY, str(tmp_path), checks)
    cs.phase_vol512(sc, TINY.big_n, checks)
    assert not checks.failed


def test_smoke_fast_vs_exact_parity(capsys):
    checks = cs.Checks()
    cs.parity_fast_exact(TINY, checks)
    out = capsys.readouterr().out
    assert not checks.failed, out
    assert "gradient cosine" in out


def test_smoke_golden_parity():
    checks = cs.Checks()
    cs.parity_goldens(checks, names=["bos_rotated_128"])
    assert not checks.failed


def test_smoke_four_cards_on_virtual_devices(tmp_path):
    checks = cs.Checks()
    cs.phase_four_cards(TINY, str(tmp_path), checks)
    assert not checks.failed


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_exits_nonzero_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cs.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_measure_prints_smoke_timings(capsys):
    out = cs.measure("square", lambda x: x * x, jnp.arange(4.0))
    np.testing.assert_array_equal(np.asarray(out), [0.0, 1.0, 4.0, 9.0])
    line = capsys.readouterr().out
    assert "[smoke] square: compile" in line and "steady median" in line
    assert "not a benchmark metric" in line


def test_checks_fail_on_tolerance_and_nan(capsys):
    checks = cs.Checks()
    checks.value("small", 1e-5, 1e-4)
    checks.value("big", 1e-3, 1e-4)
    checks.value("nan", float("nan"), 1.0)
    checks.value("at least", 2.0, 1.0, at_least=True)
    checks.true("false", False)
    assert checks.failed == ["big", "nan", "false"]
    assert "FAIL" in capsys.readouterr().out


def test_device_record_is_what_jax_reports():
    from photon_tpu.utils.device import device_record

    d = jax.devices()
    assert device_record(d) == {"platform": d[0].platform,
                                "kind": d[0].device_kind, "count": len(d)}
