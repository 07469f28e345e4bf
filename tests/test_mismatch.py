"""Hamming-distance<=1 counting — `count --mismatches 1`.

Batched formulation of approximate matching (tpufm extension; the reference has
none): each read's 3L+1 single-substitution variants are generated on device
and ride the ordinary batched scan as extra batch lanes — no branchy
backtracking, full sensitivity, exact counts. Ground truth here is a naive
sliding-window Hamming scan of the text.
"""

import numpy as np
import pytest

from tpufm.config import IndexConfig
from tpufm.engine.xla import XLAEngine
from tpufm.index.builder import build_index


def _naive_mm_count(codes, read, dist=1):
    wins = np.lib.stride_tricks.sliding_window_view(codes, read.shape[0])
    return int(((wins != read[None, :]).sum(axis=1) <= dist).sum())


def _setup(rng, n=1500, k=2, d=64):
    # small alphabet-4 text has plenty of <=1-mismatch near-hits at short L
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling")
    return codes, index


@pytest.mark.parametrize("qlen,k,lut", [(8, 2, 0), (12, 2, 4), (12, 3, 6)])
def test_count_mismatch_matches_naive(rng, qlen, k, lut):
    codes, index = _setup(rng, k=k)
    eng = XLAEngine(index, lut_m=lut)
    starts = rng.integers(0, len(codes) - qlen, size=24)
    qs = np.stack([codes[s : s + qlen] for s in starts])
    qs = np.concatenate([qs, rng.integers(0, 4, size=(8, qlen), dtype=np.uint8)])
    got = eng.count(qs, mismatches=1)
    want = np.array([_naive_mm_count(codes, q) for q in qs], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
    # sampled reads have >= their exact occurrence
    exact = eng.count(qs, mismatches=0)
    assert (got >= exact).all() and (exact[:24] >= 1).all()


def test_count_exact_equals_interval_width(rng):
    codes, index = _setup(rng)
    eng = XLAEngine(index)
    qs = rng.integers(0, 4, size=(32, 10), dtype=np.uint8)
    iv = eng.search(qs)
    np.testing.assert_array_equal(eng.count(qs), iv[:, 1] - iv[:, 0])


def test_count_mismatch_with_tail(rng):
    # odd length: variants preserve L, tail rounds apply to every variant
    codes, index = _setup(rng, k=3)
    tail = build_index(codes, IndexConfig(k=1, d=64), sa_method="doubling")
    eng = XLAEngine(index, tail_index=tail)
    qlen = 11  # 11 % 3 == 2
    starts = rng.integers(0, len(codes) - qlen, size=16)
    qs = np.stack([codes[s : s + qlen] for s in starts])
    got = eng.count(qs, mismatches=1)
    want = np.array([_naive_mm_count(codes, q) for q in qs], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_count_mismatch_waves(rng):
    # result must not depend on the wave split
    codes, index = _setup(rng)
    eng = XLAEngine(index)
    qs = rng.integers(0, 4, size=(64, 8), dtype=np.uint8)
    np.testing.assert_array_equal(
        eng.count(qs, mismatches=1, wave=7), eng.count(qs, mismatches=1)
    )


def test_count_mismatch_e2_rejected(rng):
    codes, index = _setup(rng)
    with pytest.raises(NotImplementedError, match="mismatches=2"):
        XLAEngine(index).count(np.zeros((4, 8), np.uint8), mismatches=2)


def test_cli_count(tmp_path, rng, monkeypatch):
    from tpufm import cli
    from tpufm.io.fasta import write_reference
    from tpufm.utils.encoding import decode_bases

    monkeypatch.chdir(tmp_path)
    codes = rng.integers(0, 4, size=2000, dtype=np.uint8)
    write_reference("ref.fa", decode_bases(codes))
    cli.main(["build", "ref.fa", "2000", "--k", "2", "--d", "64"])
    fmi = "ref.fa.2000.64fmi2steps.fmi"
    qlen = 10
    starts = rng.integers(0, 2000 - qlen, size=16)
    qs = np.stack([codes[s : s + qlen] for s in starts])
    with open("q.qry", "wb") as fp:
        for i in range(16):
            fp.write(b"> r%d\n%s\n" % (i, decode_bases(qs[i])))
    cli.main(["count", fmi, "q.qry", str(qlen), "16",
              "--mismatches", "1", "--rc", "--output", "c.cnt"])
    got = np.loadtxt("c.cnt", dtype=np.uint32)
    want = np.array([_naive_mm_count(codes, q) for q in qs], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "c.cnt.rc").exists()


def test_locate_mismatch_matches_naive(rng):
    """locate_mismatch: the position SET of Hamming<=1 hits equals a naive
    text scan (max_hits large enough that nothing truncates)."""
    from tpufm.engine.xla import SearchLocateEngine
    from tpufm.index.locate import build_locate
    from tpufm.index.suffix_array import suffix_array

    codes = rng.integers(0, 4, size=1500, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=8, d=64, sa=sa)
    eng = SearchLocateEngine(index, loc, max_hits=64)

    qlen = 9
    starts = rng.integers(0, 1500 - qlen, size=16)
    qs = np.stack([codes[s : s + qlen] for s in starts])
    pos = eng.locate_mismatch(qs)
    wins = np.lib.stride_tricks.sliding_window_view(codes, qlen)
    for i, q in enumerate(qs):
        want = set(np.flatnonzero((wins != q[None]).sum(1) <= 1).tolist())
        got = set(int(x) for x in pos[i] if x != 0xFFFFFFFF)
        assert len(want) <= 64, "test setup: raise max_hits"
        assert got == want, (i, sorted(got), sorted(want))


def test_locate_mismatch_cap_and_waves(rng):
    from tpufm.engine.xla import SearchLocateEngine
    from tpufm.index.locate import build_locate
    from tpufm.index.suffix_array import suffix_array

    codes = rng.integers(0, 4, size=1200, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=8, d=64, sa=sa)
    eng = SearchLocateEngine(index, loc, max_hits=2)
    qs = rng.integers(0, 4, size=(24, 6), dtype=np.uint8)  # short -> many hits
    pos = eng.locate_mismatch(qs)
    assert pos.shape == (24, 2)
    # fill count = min(true <=1-mm count, max_hits), exactly
    wins = np.lib.stride_tricks.sliding_window_view(codes, 6)
    want_n = np.array(
        [min(2, int(((wins != q[None]).sum(1) <= 1).sum())) for q in qs]
    )
    np.testing.assert_array_equal((pos != 0xFFFFFFFF).sum(1), want_n)
    # wave split must not change results
    np.testing.assert_array_equal(eng.locate_mismatch(qs, wave=5), pos)
    # every reported position is a genuine <=1-mismatch site
    for i, q in enumerate(qs):
        for x in pos[i]:
            if x != 0xFFFFFFFF:
                assert (wins[int(x)] != q).sum() <= 1


def test_cli_locate_mismatch(tmp_path, rng, monkeypatch):
    from tpufm import cli
    from tpufm.io.fasta import write_reference
    from tpufm.utils.encoding import decode_bases

    monkeypatch.chdir(tmp_path)
    codes = rng.integers(0, 4, size=2000, dtype=np.uint8)
    write_reference("g.fa", decode_bases(codes))
    qlen = 15
    starts = rng.integers(0, 2000 - qlen, size=12)
    qs = np.stack([codes[s : s + qlen] for s in starts])
    mut = qs.copy()  # plant one error per read
    p = rng.integers(0, qlen, size=12)
    mut[np.arange(12), p] = (mut[np.arange(12), p] + 1) % 4
    with open("q.qry", "wb") as fp:
        for i in range(12):
            fp.write(b"> r%d\n%s\n" % (i, decode_bases(mut[i])))
    cli.main(["locate", "g.fa", "2000", "q.qry", str(qlen), "12",
              "--k", "2", "--d", "64", "--sample-rate", "8",
              "--mismatches", "1", "--output", "m.pos"])
    lines = open("m.pos").read().splitlines()
    assert len(lines) == 12
    for line, s in zip(lines, starts):
        assert str(int(s)) in line.split()  # origin recovered despite error


def test_count_mismatch_data_parallel(rng):
    """DataParallelEngine.count over the virtual mesh == XLAEngine.count,
    including the mismatch fan-out, odd lengths, and a non-mesh-multiple
    batch."""
    import jax

    from tpufm.parallel import DataParallelEngine, make_mesh

    codes, index = _setup(rng, k=3)
    tail = build_index(codes, IndexConfig(k=1, d=64), sa_method="doubling")
    mesh = make_mesh(len(jax.devices()))
    dp = DataParallelEngine(index, mesh, tail_index=tail)
    sc = XLAEngine(index, tail_index=tail)
    qs = rng.integers(0, 4, size=(21, 10), dtype=np.uint8)  # 21 % 8 != 0
    np.testing.assert_array_equal(dp.count(qs), sc.count(qs))
    np.testing.assert_array_equal(
        dp.count(qs, mismatches=1), sc.count(qs, mismatches=1)
    )


def test_cli_count_mesh(tmp_path, rng, monkeypatch):
    from tpufm import cli
    from tpufm.io.fasta import write_reference
    from tpufm.utils.encoding import decode_bases

    monkeypatch.chdir(tmp_path)
    codes = rng.integers(0, 4, size=2000, dtype=np.uint8)
    write_reference("ref.fa", decode_bases(codes))
    cli.main(["build", "ref.fa", "2000", "--k", "2", "--d", "64"])
    fmi = "ref.fa.2000.64fmi2steps.fmi"
    cli.main(["genreads", "ref.fa", "2000", "10", "16", "--output", "q.qry"])
    cli.main(["count", fmi, "q.qry", "10", "16",
              "--mismatches", "1", "--output", "a.cnt"])
    cli.main(["count", fmi, "q.qry", "10", "16",
              "--mismatches", "1", "--mesh", "8", "--output", "b.cnt"])
    assert (tmp_path / "a.cnt").read_text() == (tmp_path / "b.cnt").read_text()


def test_locate_mismatch_data_parallel(rng):
    import jax

    from tpufm.engine.xla import SearchLocateEngine
    from tpufm.index.locate import build_locate
    from tpufm.index.suffix_array import suffix_array
    from tpufm.parallel import make_mesh
    from tpufm.parallel.locate import DataParallelSearchLocate

    codes = rng.integers(0, 4, size=1500, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=8, d=64, sa=sa)
    qs = rng.integers(0, 4, size=(21, 9), dtype=np.uint8)  # 21 % 8 != 0
    single = SearchLocateEngine(index, loc, max_hits=8).locate_mismatch(qs)
    mesh = make_mesh(len(jax.devices()))
    dp = DataParallelSearchLocate(index, loc, mesh, max_hits=8)
    np.testing.assert_array_equal(dp.locate_mismatch(qs), single)
