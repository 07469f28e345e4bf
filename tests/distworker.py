"""Multi-process SPMD worker for tests/test_multiprocess.py.

Each process joins a jax.distributed cluster (CPU backend, 2 virtual
devices per process), builds the SAME tiny index deterministically, runs
DataParallelEngine over the GLOBAL mesh, and writes its view of the
replicated result. Run: python distworker.py <coordinator> <nproc> <pid>
<outdir>. CPU-only by design: on a GPU host each process would reserve
most of a card's memory, so the card path stays one process per card."""

import os
import sys

coordinator, nproc, pid, outdir = (
    sys.argv[1],
    int(sys.argv[2]),
    int(sys.argv[3]),
    sys.argv[4],
)
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Pin the CPU backend via jax.config too, before any backend initializes
# (same as tests/conftest.py): these workers are CPU-only by design.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

import numpy as np  # noqa: E402

from tpufm.config import IndexConfig  # noqa: E402
from tpufm.index.builder import build_index  # noqa: E402
from tpufm.io.genreads import generate_reads  # noqa: E402
from tpufm.parallel import initialize_distributed, make_mesh  # noqa: E402
from tpufm.parallel.search import (  # noqa: E402
    DataParallelEngine,
    ShardedIndexEngine,
)

initialize_distributed(coordinator, num_processes=nproc, process_id=pid)

assert jax.process_count() == nproc
assert len(jax.devices()) == 2 * nproc

rng = np.random.default_rng(7)
codes = rng.integers(0, 4, size=4096, dtype=np.uint8)
index = build_index(codes, IndexConfig(k=2, d=32))
queries = generate_reads(codes, 24, 64, seed=8)

mesh = make_mesh()  # all 2*nproc global devices
eng = DataParallelEngine(index, mesh, lut_m=4)
out = eng.search(queries)

np.save(os.path.join(outdir, f"result_{pid}.npy"), out)

# Sharded-index mode across PROCESSES: the entry table split over the
# global mesh, lookups routed with collectives spanning both workers.
for routing in ("allgather", "ring", "a2a"):
    sh = ShardedIndexEngine(index, mesh, routing=routing, lut_m=2)
    out_sh = sh.search(queries)
    np.save(os.path.join(outdir, f"result_{routing}_{pid}.npy"), out_sh)

# Multi-process locate: replicated tables, row batch sharded over the
# global mesh (row count deliberately not a mesh multiple).
from tpufm.index.locate import build_locate  # noqa: E402
from tpufm.parallel import DataParallelLocate  # noqa: E402

loc = build_locate(codes, sample_rate=8, d=32)
rows = rng.integers(0, len(codes) + 1, size=101, dtype=np.uint32)
pos = DataParallelLocate(loc, mesh).locate_rows(rows)
np.save(os.path.join(outdir, f"locate_{pid}.npy"), pos)
np.save(os.path.join(outdir, f"locate_rows_{pid}.npy"), rows)

# Sharded BUILD across processes: suffix sort + table pipeline over the
# global mesh, then sharded search of the freshly built index.
from tpufm.index.builder_sharded import build_index_sharded  # noqa: E402

idx_sh = build_index_sharded(codes, IndexConfig(k=2, d=32), mesh)
out_bs = ShardedIndexEngine(idx_sh, mesh).search(queries)
np.save(os.path.join(outdir, f"result_shbuild_{pid}.npy"), out_bs)
np.save(
    os.path.join(outdir, f"shbuild_occ_{pid}.npy"),
    np.asarray(idx_sh.occ, np.uint32),
)

# Seed-and-extend across processes: the packed text replicated over the
# GLOBAL mesh, query batch sharded across both workers (batch 21 is
# neither a mesh multiple nor larger than the mesh cleanly).
from tpufm.parallel import DataParallelSearchLocate  # noqa: E402

mut = np.stack([codes[s : s + 24].copy() for s in rng.integers(0, 4000, 21)])
for i in range(21):
    for p in rng.choice(24, size=2, replace=False):
        mut[i, p] = (mut[i, p] + rng.integers(1, 4)) & 3
dpsl = DataParallelSearchLocate(index, loc, mesh, max_hits=8)
spos, scnt, sovf = dpsl.locate_approx(mut, codes, mismatches=2, seed_hits=64)
np.save(os.path.join(outdir, f"seed_pos_{pid}.npy"), spos)
np.save(os.path.join(outdir, f"seed_cnt_{pid}.npy"), scnt)
np.save(os.path.join(outdir, f"seed_mut_{pid}.npy"), mut)

print(f"worker {pid}: ok", flush=True)
