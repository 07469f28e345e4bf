"""tpufm — k-step FM-index search engine in JAX.

A JAX/XLA framework with the capabilities of the achacond/k-step_FM-index
benchmarking suite (see SURVEY.md): builds k-step FM-indexes (BWT +
block-sampled Occ counters + 2-bit-plane bitmaps) from DNA references on
the host or the device, and runs exact-match backward search over large
read batches on a GPU, bit-exact against the reference CPU baseline
(src/fmIndexCPUBaseline.c).

Layer map (a batched redesign of SURVEY.md section 1):
  tpufm.index     — index construction (suffix array, k-BWTs, counters,
                    bitmaps) on host or device, and layout transforms
  tpufm.engine    — search engines: NumPy oracle, XLA gather engine
  tpufm.parallel  — device mesh / pjit data-parallel + sharded-index search
  tpufm.io        — FASTA / query / result / .fmi file formats
  tpufm.utils     — base encoding, timers, run records
"""

from tpufm.config import IndexConfig, Layout, recommend_config
from tpufm.index.builder import build_index, KStepFMIndex
from tpufm.index.locate import build_locate, LocateIndex
from tpufm.index.store import save_store, load_store

__version__ = "0.1.0"

__all__ = [
    "IndexConfig",
    "Layout",
    "recommend_config",
    "build_index",
    "KStepFMIndex",
    "build_locate",
    "LocateIndex",
    "save_store",
    "load_store",
    "__version__",
]
