"""Test environment: force the CPU backend with 8 virtual devices so
sharding/collective paths are exercised without accelerator hardware
(SURVEY.md section 4's multi-host test recipe). Must run before jax is
imported. The GPU path runs through `python chip_smoke.py` on a card."""

import os

# Force CPU: tests must be deterministic, fast, and exercise an 8-device
# mesh whatever accelerator the host has. Set through jax.config too, in
# case jax was imported before this file (backends initialize lazily, so
# this works as long as nothing touched a backend yet).
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def naive_interval(text_codes, pattern_codes):
    """Ground-truth SA interval via sorted-suffix binary search over
    T = text + '$' ('$' smallest). Returns (L, R): ranks of suffixes having
    `pattern` as a prefix."""
    import bisect

    t = bytes(bytearray(int(c) + 1 for c in text_codes)) + b""
    # sentinel: suffix comparison of t with implicit end-of-string works like
    # '$' smallest because shorter-prefix < longer in bytes comparison.
    n = len(t)
    suffixes = sorted(range(n + 1), key=lambda i: t[i:])
    keys = [t[i:] for i in suffixes]
    p = bytes(bytearray(int(c) + 1 for c in pattern_codes))
    lo = bisect.bisect_left(keys, p)
    hi = bisect.bisect_left(keys, p + b"\xff")
    return lo, hi
