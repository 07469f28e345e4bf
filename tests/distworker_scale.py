"""Chromosome-scale multi-process worker (BASELINE.md target 5).

Loads a prebuilt 100 Mbase index from the mmap .tpufm store, joins a
2-process jax.distributed cluster (2 virtual CPU devices each), and runs
DataParallelEngine with a device-built prefix LUT over the global 4-device
mesh, streaming the read batch in waves. Run:
python distworker_scale.py <coordinator> <nproc> <pid> <workdir>.
CPU-only by design, like distworker.py."""

import os
import sys

coordinator, nproc, pid, workdir = (
    sys.argv[1],
    int(sys.argv[2]),
    int(sys.argv[3]),
    sys.argv[4],
)
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

import numpy as np  # noqa: E402

from tpufm.index.store import load_store  # noqa: E402
from tpufm.parallel import initialize_distributed, make_mesh  # noqa: E402
from tpufm.parallel.search import DataParallelEngine  # noqa: E402

initialize_distributed(coordinator, num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc

index = load_store(os.path.join(workdir, "chrom.tpufm"))  # mmap open
queries = np.load(os.path.join(workdir, "queries.npy"))

mesh = make_mesh()
eng = DataParallelEngine(index, mesh, lut_m=9)

# Stream the batch in waves through the global mesh (the target's
# "data-parallel streaming + collective merge" shape).
from tpufm.utils.waves import stream_waves  # noqa: E402

out = stream_waves(
    queries,
    2048,
    lambda q: eng.search_device(eng.shard_queries(q)),
    lambda h: np.asarray(jax.device_get(h)),
    depth=2,
)
np.save(os.path.join(workdir, f"chrom_result_{pid}.npy"), out)
print(f"scale worker {pid}: ok", flush=True)
