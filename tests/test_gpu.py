"""Checks that need an NVIDIA GPU. This suite's conftest pins the CPU
backend, so they skip here; on a card the same checks run as the phases
of `python chip_smoke.py`."""

import jax
import pytest

import chip_smoke as cs


@pytest.fixture
def gpu():
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; on a card run `python chip_smoke.py`, "
                    "whose phases these are")
    return devs[0]


@pytest.mark.gpu
def test_main_path_on_gpu(gpu, tmp_path):
    s = cs.Smoke(plan=cs.Plan(refsize=10_000_000, parity_refsize=1_000_000),
                 work=tmp_path)
    for name, fn in cs.PHASES.items():
        assert cs.run_phase(name, fn, s)["phase"] == name
