"""Engine protocol — the tpufm equivalent of the reference's 15-function
opaque-pointer C ABI (reference common/interface.h:27-41).

The reference swapped engines at LINK time (one binary per variant,
makefile:156-207); tpufm engines are objects selected at runtime, all
producing bit-identical SA intervals:

  tpufm.engine.oracle.search_oracle   — NumPy host oracle (the semantics spec)
  tpufm.engine.XLAEngine              — single-device XLA gather engine
                                        (layouts: fused / split / alt-counters)
  tpufm.parallel.DataParallelEngine   — multi-chip, replicated index
  tpufm.parallel.ShardedIndexEngine   — multi-chip, sharded index

Mapping from the reference ABI:
  loadIndex/saveIndex      -> tpufm.index.formats.read_fmi/write_fmi/*.npz
  buildIndex               -> tpufm.index.builder.build_index
  searchIndexCPU/GPU       -> Engine.search
  initResults              -> implicit (engines return fresh arrays)
  transferCPUtoGPU/GPUtoCPU-> jax.device_put / jax.device_get (Engine ctor /
                              Engine.search do both)
  free*                    -> garbage collection
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Engine(Protocol):
    """Batch exact-match backward search over a built k-step FM-index."""

    def search(self, queries: np.ndarray) -> np.ndarray:
        """queries: uint8 [B, L] 2-bit base codes, L divisible by k.
        Returns uint32 [B, 2] SA intervals (L, R); occurrences = R - L."""
        ...
