"""chip_smoke.py on the CPU: each phase at a tiny size (the full run
needs a GPU), the four-card path on four of the virtual devices, and the
script's refusal to run without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs

TINY = cs.Plan(
    refsize=30_000, parity_refsize=5_000, reads=2048, oracle_sample=512,
    absent=64, locate_reads=256, pairs=128, approx_reads=64, lut=6,
)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """One tiny run shared by the phase tests; each test first runs the
    phases before it that have not run yet."""
    return cs.Smoke(plan=TINY, work=tmp_path_factory.mktemp("smoke")), set()


@pytest.mark.parametrize("name", list(cs.PHASES))
def test_phase_tiny(smoke, name, monkeypatch, capsys):
    s, done = smoke
    monkeypatch.setattr(cs, "card_info", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for prev in cs.PHASES:
        if prev == name:
            break
        if prev not in done:
            cs.run_phase(prev, cs.PHASES[prev], s)
            done.add(prev)
    line = cs.run_phase(name, cs.PHASES[name], s)
    done.add(name)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["phase"] == name and printed["wall_seconds"] > 0
    assert line["peak_bytes_in_use"] is None  # the CPU reports no memory stats
    expect = {
        "env": {"platform": "cpu", "device_count": 8},
        "build": {"k": 3, "d": 192, "bwtsize": TINY.refsize + 1},
        "search": {"oracle_checked": 512, "absent_checked": 64},
        "locate": {"origins_found": 256,
                   "records_at_planted_position_and_strand": 256},
        "approx": {"mismatch_origins_found": 64, "edit_origins_within_2E": 64},
    }[name]
    assert {k: line[k] for k in expect} == expect
    if name == "build":
        assert line["sa_rounds"]  # the device sort logged its rounds


def test_phase_mesh_tiny(tmp_path):
    s = cs.Smoke(plan=TINY, work=tmp_path)
    line = cs.run_phase("mesh", lambda s: cs.phase_mesh(s, 4), s)
    assert line["bit_identical_to_one_card"] == [
        "dp", "sharded_a2a", "sharded_allgather", "sharded_ring"
    ]
    # the CPU reports no memory stats, so placement is not read here
    assert line["sharded_build_peak_bytes"] == [None] * 4
    assert line["per_device_peak_bytes"] == [None] * 4
    assert line["per_device_table_bytes"] == dict.fromkeys(
        line["bit_identical_to_one_card"])


def test_held_engines_restores_factory():
    from tpufm import cli as tpufm_cli

    make = tpufm_cli._make_engine
    with cs._held_engines() as engines:
        assert tpufm_cli._make_engine is not make
        assert engines == []
    assert tpufm_cli._make_engine is make


def test_check_raises():
    cs.check(True, "fine")
    with pytest.raises(cs.SmokeFailure, match="boom"):
        cs.check(False, "boom")


def test_refuses_cpu():
    root = Path(cs.__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py")], cwd=root, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 2
    assert "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout
