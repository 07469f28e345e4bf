"""Multi-host bring-up, actually exercised: 2 OS processes x 2 virtual CPU
devices join one jax.distributed cluster and run DataParallelEngine over
the global 4-device mesh (BASELINE.md scaling design; SURVEY.md section 5
'distributed communication backend'). Every process's replicated result
must be bit-exact vs the single-process oracle.

CPU-only by design: each worker process would reserve most of a card's
memory, so the GPU path stays one process per card (chip_smoke.py)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_data_parallel(tmp_path):
    from tpufm.config import IndexConfig
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.builder import build_index
    from tpufm.io.genreads import generate_reads

    worker = Path(__file__).parent / "distworker.py"
    coordinator = f"127.0.0.1:{_free_port()}"
    nproc = 2
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coordinator, str(nproc), str(pid),
             str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    # The deterministic workload the workers ran (same seeds).
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=4096, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=32))
    queries = generate_reads(codes, 24, 64, seed=8)
    expect = search_oracle(index, queries)

    from tpufm.index.locate import build_locate, locate_oracle

    loc = build_locate(codes, sample_rate=8, d=32)
    for pid in range(nproc):
        got = np.load(tmp_path / f"result_{pid}.npy")
        np.testing.assert_array_equal(got, expect)
        # sharded-index results, all three routings, from every process
        for routing in ("allgather", "ring", "a2a"):
            got_sh = np.load(tmp_path / f"result_{routing}_{pid}.npy")
            np.testing.assert_array_equal(got_sh, expect)
        # multi-process locate (replicated tables, row-sharded walk)
        rows = np.load(tmp_path / f"locate_rows_{pid}.npy")
        np.testing.assert_array_equal(
            np.load(tmp_path / f"locate_{pid}.npy"), locate_oracle(loc, rows)
        )
        # sharded BUILD across processes: occ bit-identical to the host
        # build, and the built index searches correctly sharded
        np.testing.assert_array_equal(
            np.load(tmp_path / f"shbuild_occ_{pid}.npy"),
            np.asarray(index.occ, np.uint32),
        )
        np.testing.assert_array_equal(
            np.load(tmp_path / f"result_shbuild_{pid}.npy"), expect
        )
        # seed-and-extend across processes (batch sharded over both
        # workers, packed text replicated): exact vs the naive oracle
        from tpufm.engine.seed import seed_extend_oracle

        mut = np.load(tmp_path / f"seed_mut_{pid}.npy")
        spos = np.load(tmp_path / f"seed_pos_{pid}.npy")
        scnt = np.load(tmp_path / f"seed_cnt_{pid}.npy")
        want_cnt, want_pos = seed_extend_oracle(codes, mut, 2)
        np.testing.assert_array_equal(scnt, want_cnt)
        for row, wrow in zip(spos, want_pos):
            keep = row != np.uint32(0xFFFFFFFF)
            np.testing.assert_array_equal(row[keep], wrow[: keep.sum()])


@pytest.mark.skipif(
    not os.environ.get("TPUFM_SCALE_TESTS"),
    reason="set TPUFM_SCALE_TESTS=1 (several minutes: 100 Mbase build)",
)
def test_chromosome_scale_two_hosts(tmp_path):
    """BASELINE.md target 5 end-to-end: chromosome-scale (100 Mbase) index,
    N=2 OS processes (the multi-host analog), data-parallel wave streaming
    with a device-built LUT, results merged via the replicated out-sharding
    — bit-exact vs the oracle, index distributed via the mmap store."""
    from tpufm.config import IndexConfig
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.builder import build_index
    from tpufm.index.store import save_store
    from tpufm.io.genreads import generate_reads

    n = 100_000_000
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=3, d=128))
    save_store(tmp_path / "chrom.tpufm", index)
    queries = generate_reads(codes, 120, 8192, seed=12)
    np.save(tmp_path / "queries.npy", queries)
    expect = search_oracle(index, queries)

    worker = Path(__file__).parent / "distworker_scale.py"
    coordinator = f"127.0.0.1:{_free_port()}"
    nproc = 2
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coordinator, str(nproc), str(pid),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(nproc)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"scale worker failed:\n{out.decode()}"
    for pid in range(nproc):
        got = np.load(tmp_path / f"chrom_result_{pid}.npy")
        np.testing.assert_array_equal(got, expect)
