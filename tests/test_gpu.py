"""Parity on an NVIDIA GPU: run with ``python -m pytest -m gpu tests/`` on
a machine with one.  Here they skip (the ``gpu_device`` fixture finds no
card)."""
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_goldens_on_gpu(gpu_device):
    checks = cs.Checks()
    cs.parity_goldens(checks)
    assert not checks.failed


def test_fast_vs_exact_on_gpu(gpu_device):
    checks = cs.Checks()
    cs.parity_fast_exact(cs.FULL, checks)
    assert not checks.failed


def test_smoke_bos_on_gpu(gpu_device, tmp_path):
    """The BOS phase, its gradient and the tube-vs-dense parity, at a
    reduced size (the full size is chip_smoke.py's)."""
    sz = cs.FULL._replace(bos_dots=100, sensor=512)
    checks = cs.Checks()
    sc, img = cs.phase_bos(sz, str(tmp_path), checks)
    cs.phase_bos_grad(sc, img, checks)
    cs.parity_tube_dense(sc, checks)
    assert not checks.failed
