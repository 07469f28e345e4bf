"""Shared fixed-shape wave streaming.

Every engine streams oversized batches through the device in fixed-size
waves (one compiled shape, constant device memory), optionally keeping
several dispatches in flight so host<->device staging overlaps compute.
This is the single implementation all engines use (XLA search, locate
walk, sharded mesh search).
"""

from __future__ import annotations

import numpy as np


def pad_cycle(arr: np.ndarray, pad: int) -> np.ndarray:
    """Append `pad` rows by cycling arr's own rows — unlike `arr[:pad]`
    this stays correct when pad exceeds len(arr) (tiny batch on a large
    mesh). np.resize cycles the flattened buffer, which is row-cycling
    here because trailing dims are preserved."""
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.resize(arr, (pad,) + arr.shape[1:])])


def stream_waves(
    items: np.ndarray,
    wave: int,
    dispatch,
    fetch,
    depth: int = 1,
    pad_mode: str = "zero",
):
    """Split items [B, ...] into `wave`-sized chunks (tail padded to keep
    ONE compiled shape), dispatch each, fetch with `depth` in flight, and
    concatenate the un-padded results.

    dispatch(chunk) -> handle (async device dispatch, no host sync);
    fetch(handle) -> np.ndarray [wave, ...].
    pad_mode "zero" pads the tail with zeros; "cycle" tiles the tail's own
    rows (keeps the wave's value distribution — e.g. for bucket-skew
    statistics in the sharded engine).
    """
    if wave <= 0:
        raise ValueError(f"wave must be positive, got {wave}")
    B = items.shape[0]
    if B <= wave:
        return fetch(dispatch(items))[:B]
    outs = []
    pending = []

    def drain():
        handle, pad = pending.pop(0)
        out = fetch(handle)
        outs.append(out[: wave - pad] if pad else out)

    for start in range(0, B, wave):
        chunk = items[start : start + wave]
        pad = wave - chunk.shape[0]
        if pad:
            if pad_mode == "cycle":
                reps = -(-wave // chunk.shape[0])
                chunk = np.concatenate([chunk] * reps)[:wave]
            else:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)]
                )
        pending.append((dispatch(chunk), pad))
        if len(pending) >= depth:
            drain()
    while pending:
        drain()
    return np.concatenate(outs)
