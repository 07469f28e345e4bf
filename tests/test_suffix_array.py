import numpy as np
import pytest

from tpufm.index.suffix_array import (
    suffix_array_doubling,
    suffix_array_naive,
    suffix_array_native,
)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 10, 100, 1000])
def test_doubling_matches_naive(rng, n):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    np.testing.assert_array_equal(
        suffix_array_doubling(codes), suffix_array_naive(codes)
    )


def test_repetitive_text(rng):
    # Heavy repeats stress rank-compression and LMS naming.
    for pat in [b"\x00", b"\x00\x01", b"\x03\x03\x00", b"\x00\x01\x02\x03"]:
        codes = np.frombuffer(pat * 200, dtype=np.uint8).copy()
        np.testing.assert_array_equal(
            suffix_array_doubling(codes), suffix_array_naive(codes)
        )


def test_native_matches_doubling(rng):
    native_probe = suffix_array_native(np.zeros(4, dtype=np.uint8))
    if native_probe is None:
        pytest.skip("native SA-IS library unavailable")
    for n in [1, 2, 5, 37, 1000, 20000]:
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        np.testing.assert_array_equal(
            suffix_array_native(codes), suffix_array_doubling(codes)
        )
    for pat in [b"\x00", b"\x01\x00", b"\x02\x02\x01\x00"]:
        codes = np.frombuffer(pat * 500, dtype=np.uint8).copy()
        np.testing.assert_array_equal(
            suffix_array_native(codes), suffix_array_doubling(codes)
        )


def test_sentinel_rank_zero(rng):
    codes = rng.integers(0, 4, size=64, dtype=np.uint8)
    sa = suffix_array_doubling(codes)
    assert sa[0] == 64  # the '$' suffix sorts first
    assert sorted(sa.tolist()) == list(range(65))


def test_native_large_random(rng):
    # ~1M-base random text: exercises deep SA-IS recursion levels.
    if suffix_array_native(np.zeros(4, dtype=np.uint8)) is None:
        pytest.skip("native SA-IS library unavailable")
    codes = rng.integers(0, 4, size=1_000_000, dtype=np.uint8)
    sa = suffix_array_native(codes)
    assert sa[0] == 1_000_000
    # spot-check sortedness at 1000 random adjacent pairs
    idx = rng.integers(1, 1_000_000, size=1000)
    for i in idx:
        a, b = int(sa[i]), int(sa[i + 1])
        assert codes.tobytes()[a:a+64] <= codes.tobytes()[b:b+64]


def test_native_rejects_byte_255(rng):
    # 255 + 1 would wrap to the sentinel symbol; the library must refuse,
    # not silently return a wrong SA.
    if suffix_array_native(np.zeros(4, dtype=np.uint8)) is None:
        pytest.skip("native SA-IS library unavailable")
    with pytest.raises(RuntimeError, match="code -3"):
        suffix_array_native(np.array([255, 1, 255, 0], np.uint8))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 10, 100, 1000, 4097])
def test_device_matches_doubling(rng, n):
    # Prefix doubling ON the device (CPU backend in tests; same program on
    # the GPU) must be bit-identical to the host paths.
    from tpufm.index.sa_device import suffix_array_device

    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    np.testing.assert_array_equal(
        suffix_array_device(codes), suffix_array_doubling(codes)
    )


def test_device_repetitive_text():
    # Worst case for doubling: heavy repeats force the full log rounds.
    from tpufm.index.sa_device import suffix_array_device

    for pat in [b"\x00", b"\x00\x01", b"\x03\x03\x00", b"\x00\x01\x02\x03"]:
        codes = np.frombuffer(pat * 700, dtype=np.uint8).copy()
        np.testing.assert_array_equal(
            suffix_array_device(codes), suffix_array_doubling(codes)
        )


def test_device_rejects_wide_alphabet(rng):
    # the initial rank packs symbol+1 into 3 bits; larger symbols must be
    # rejected loudly, not silently missorted
    from tpufm.index.sa_device import suffix_array_device

    codes = rng.integers(0, 200, size=100, dtype=np.uint8)
    codes[0] = 100
    with pytest.raises(ValueError, match=r"\[0, 6\]"):
        suffix_array_device(codes)


@pytest.mark.parametrize("kind", ["random", "repetitive", "single"])
def test_device_two_pass_sort_matches_native(rng, kind):
    # each doubling round sorts (rank, second) as two stable single-key
    # sorts; the result must equal native SA-IS on texts that take one,
    # several and all ceil(log2(n/10)) rounds
    from tpufm.index.sa_device import suffix_array_device

    n = 5000
    codes = {
        "random": rng.integers(0, 4, size=n, dtype=np.uint8),
        "repetitive": np.frombuffer(b"\x00\x01\x02" * (n // 3), np.uint8).copy(),
        "single": np.full(n, 2, np.uint8),
    }[kind]
    want = suffix_array_native(codes)
    if want is None:
        pytest.skip("native SA-IS library unavailable")
    np.testing.assert_array_equal(suffix_array_device(codes), want)


@pytest.mark.parametrize(
    "limit,ok", [(None, True), (48 * 1000, True), (48 * 1000 - 1, False)]
)
def test_device_build_capacity_guard(monkeypatch, limit, ok):
    # the device build refuses a text whose working set exceeds the
    # device's reported allocator limit; no reported limit, no refusal
    import tpufm.config
    from tpufm.index import sa_device

    monkeypatch.setattr(sa_device, "DEVICE_BUILD_BYTES_PER_BASE", 48)
    monkeypatch.setattr(tpufm.config, "device_bytes_limit", lambda d=None: limit)
    if ok:
        sa_device.check_device_build_fits(1000)
    else:
        with pytest.raises(ValueError, match="device's limit"):
            sa_device.check_device_build_fits(1000)


@pytest.mark.parametrize("num_keys,n_ops", [(1, 2), (1, 3), (2, 3), (3, 3)])
def test_lex_sort_matches_numpy_lexsort(rng, num_keys, n_ops):
    # small key ranges force ties: ties beyond the keys keep input order
    import jax.numpy as jnp

    from tpufm.index.sa_device import lex_sort

    ops = [rng.integers(0, 4, size=3000).astype(np.uint32) for _ in range(n_ops)]
    order = np.lexsort(ops[:num_keys][::-1])  # stable, first key primary
    got = lex_sort([jnp.asarray(a) for a in ops], num_keys)
    for g, a in zip(got, ops):
        np.testing.assert_array_equal(np.asarray(g), a[order])
