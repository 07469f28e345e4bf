"""Resumable query-stream search: a run killed mid-stream must continue
from the last completed wave and produce identical results."""

import numpy as np
import pytest

from tpufm.config import IndexConfig
from tpufm.engine.oracle import search_oracle
from tpufm.engine.xla import XLAEngine
from tpufm.index.builder import build_index
from tpufm.io.genreads import generate_reads
from tpufm.io.stream import search_resumable


class _FlakyEngine:
    """Engine wrapper that dies after `die_after` search calls."""

    def __init__(self, engine, die_after):
        self._engine = engine
        self._left = die_after
        self.calls = 0

    def search(self, q):
        if self._left == 0:
            raise RuntimeError("simulated crash")
        self._left -= 1
        self.calls += 1
        return self._engine.search(q)


def test_search_resumable_roundtrip(tmp_path, rng):
    codes = rng.integers(0, 4, size=20000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=64))
    queries = generate_reads(codes, 24, 100, seed=3)
    expect = search_oracle(index, queries)
    eng = XLAEngine(index)
    out = tmp_path / "r.res"

    # Crash after 2 of 4 waves...
    flaky = _FlakyEngine(eng, die_after=2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        search_resumable(flaky, queries, out, wave=32)
    assert (tmp_path / "r.res.partial").exists()

    # ...resume completes only the remaining waves and matches the oracle.
    cont = _FlakyEngine(eng, die_after=99)
    res = search_resumable(cont, queries, out, wave=32)
    assert cont.calls == 2  # waves 3 and 4 only
    np.testing.assert_array_equal(res, expect)
    assert not (tmp_path / "r.res.partial").exists()
    assert not (tmp_path / "r.res.progress").exists()


def test_search_resumable_stale_checkpoint(tmp_path, rng):
    # A checkpoint from a different workload shape must be ignored.
    codes = rng.integers(0, 4, size=8000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=32))
    q1 = generate_reads(codes, 24, 64, seed=1)
    q2 = generate_reads(codes, 24, 96, seed=2)
    eng = XLAEngine(index)
    out = tmp_path / "s.res"

    flaky = _FlakyEngine(eng, die_after=1)
    with pytest.raises(RuntimeError):
        search_resumable(flaky, q1, out, wave=32)
    # different total => restart from scratch, correct result
    res = search_resumable(eng, q2, out, wave=32)
    np.testing.assert_array_equal(res, search_oracle(index, q2))


def test_search_resumable_torn_sidecar(tmp_path, rng):
    # a crash mid-sidecar-write leaves invalid JSON: resume must restart
    # cleanly instead of raising forever
    codes = rng.integers(0, 4, size=8000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=32))
    q = generate_reads(codes, 24, 64, seed=1)
    eng = XLAEngine(index)
    out = tmp_path / "t.res"
    flaky = _FlakyEngine(eng, die_after=1)
    with pytest.raises(RuntimeError):
        search_resumable(flaky, q, out, wave=32)
    (tmp_path / "t.res.progress").write_text("{not json")
    res = search_resumable(eng, q, out, wave=32)
    np.testing.assert_array_equal(res, search_oracle(index, q))
    assert res.flags.writeable  # np.fromfile copy, not a frombuffer view


def test_search_resumable_content_fingerprint(tmp_path, rng):
    # Same shape, DIFFERENT query content: stale waves must not be spliced
    # in (the sidecar carries a content fingerprint).
    codes = rng.integers(0, 4, size=8000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=32))
    q1 = generate_reads(codes, 24, 64, seed=1)
    q2 = generate_reads(codes, 24, 64, seed=2)  # same shape as q1
    eng = XLAEngine(index)
    out = tmp_path / "f.res"

    flaky = _FlakyEngine(eng, die_after=1)
    with pytest.raises(RuntimeError):
        search_resumable(flaky, q1, out, wave=32)
    assert (tmp_path / "f.res.partial").exists()

    cont = _FlakyEngine(eng, die_after=99)
    res = search_resumable(cont, q2, out, wave=32)
    assert cont.calls == 2  # restarted from zero: both waves re-searched
    np.testing.assert_array_equal(res, search_oracle(index, q2))


def test_search_resumable_stats_and_mesh_wave(tmp_path, rng):
    # stats['search_s'] accumulates engine time; a mesh engine's default
    # wave honors WAVE_PER_CHIP * n_dev and non-divisible tails are padded.
    import jax

    from tpufm.parallel import make_mesh, ShardedIndexEngine

    codes = rng.integers(0, 4, size=8000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=32))
    n_dev = len(jax.devices())
    # 100 queries: with wave=64 the tail chunk (36) is not a mesh multiple
    q = generate_reads(codes, 24, 100, seed=3)
    eng = ShardedIndexEngine(index, make_mesh(n_dev))
    stats = {}
    res = search_resumable(eng, q, out_path=tmp_path / "m.res", wave=64,
                           stats=stats)
    np.testing.assert_array_equal(res, search_oracle(index, q))
    assert stats["search_s"] > 0

    # Default wave comes from WAVE_PER_CHIP * n_dev for sharded engines.
    from tpufm.io.stream import _default_wave

    assert _default_wave(eng) == eng.WAVE_PER_CHIP * n_dev


def test_locate_resumable_roundtrip(tmp_path, rng):
    """locate_resumable: kill mid-run, resume, positions match the
    uninterrupted fused run."""
    from tpufm.config import IndexConfig
    from tpufm.engine.xla import SearchLocateEngine
    from tpufm.index.builder import build_index
    from tpufm.index.locate import build_locate
    from tpufm.index.suffix_array import suffix_array
    from tpufm.io.genreads import generate_reads
    from tpufm.io.stream import locate_resumable

    codes = rng.integers(0, 4, size=2000, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=8, d=64, sa=sa)
    queries = np.asarray(generate_reads(codes, 20, 100, seed=3))
    eng = SearchLocateEngine(index, loc, max_hits=4)
    out = tmp_path / "r.pos"

    calls = {"n": 0}
    real = eng.search_locate

    def flaky(chunk, wave=None):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated crash")
        return real(chunk)

    eng.search_locate = flaky
    with pytest.raises(RuntimeError):
        locate_resumable(eng, queries, out, wave=32)
    assert (tmp_path / "r.pos.partial").exists()
    eng.search_locate = real
    res = locate_resumable(eng, queries, out, wave=32)
    want = real(queries)[1]
    np.testing.assert_array_equal(res, want)
    assert not (tmp_path / "r.pos.partial").exists()


def test_cli_locate_resume(tmp_path, rng, monkeypatch):
    from tpufm import cli
    from tpufm.io.fasta import write_reference
    from tpufm.utils.encoding import decode_bases

    monkeypatch.chdir(tmp_path)
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    write_reference("g.fa", decode_bases(codes))
    cli.main(["genreads", "g.fa", "3000", "20", "16", "--seed", "8"])
    qry = "Q-16_B-20_R-3000.qry"
    base = ["locate", "g.fa", "3000", qry, "20", "16",
            "--k", "2", "--d", "64", "--sample-rate", "8"]
    cli.main([*base, "--output", "a.pos"])
    cli.main([*base, "--resume", "--output", "b.pos"])
    assert open("b.pos").read() == open("a.pos").read()
    with pytest.raises(SystemExit, match="exact position"):
        cli.main([*base, "--resume", "--sam"])
