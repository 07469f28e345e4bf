"""Index configuration.

The reference makes (k, d, layout) compile-time choices stamped into binary
names (reference makefile:140-207, -DK_STEPS/-DNUM_CHUNK/-DNUM_COUNTERS).
Here they are one dataclass resolved at trace time: a jit specialization per
config replaces the reference's compile sweep.
"""

from __future__ import annotations

import dataclasses
import enum


class Layout(enum.Enum):
    """On-device packing of the Occ/bitmap entry table.

    Mirrors the reference's four on-disk index kinds (SURVEY.md section 2):
      BASELINE     — tag 100: per-entry [bitmaps by (step, plane, window)][4^k counters]
                     (reference src/genFMindex.c:42-45)
      INTERLEAVED  — tag 101: bitmaps regrouped by (window, step, plane) so one
                     aligned 16B vector holds all 2k planes of a 32-base window
                     (reference src/transformIndexBitmaps.c:269-295)
      ALT_COUNTERS — tag 200: half the 4^k counters per entry, alternating
                     halves between even/odd entries; queries for the "other
                     half" read the next entry and count backwards
                     (reference src/transformIndexAlternateCounters.c:434-479)
      INTERLEAVED_ALT_COUNTERS — tag 201: both transforms combined
                     (reference src/transformIndexAlternateCounters.c:387-432)
    """

    BASELINE = "baseline"
    INTERLEAVED = "interleaved"
    ALT_COUNTERS = "alt_counters"
    INTERLEAVED_ALT_COUNTERS = "interleaved_alt_counters"

    @property
    def fmi_tag(self) -> int:
        return {
            Layout.BASELINE: 100,
            Layout.INTERLEAVED: 101,
            Layout.ALT_COUNTERS: 200,
            Layout.INTERLEAVED_ALT_COUNTERS: 201,
        }[self]

    @property
    def has_slim_counters(self) -> bool:
        return self in (Layout.ALT_COUNTERS, Layout.INTERLEAVED_ALT_COUNTERS)

    @staticmethod
    def from_fmi_tag(tag: int) -> "Layout":
        for layout in Layout:
            if layout.fmi_tag == tag:
                return layout
        raise ValueError(f"unknown .fmi index tag {tag}")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Static configuration of a k-step FM-index.

    k:      number of LF steps fused per memory round (reference K_STEPS).
            One lookup advances backward search by k bases.
    d:      block sampling rate in bases (reference NUM_CHUNK); each entry
            covers d BWT positions with d/32 32-bit words per bit-plane.
    layout: entry-table packing (see Layout).
    """

    k: int = 2
    d: int = 64
    layout: Layout = Layout.BASELINE

    def __post_init__(self):
        if self.k < 1 or self.k > 8:
            raise ValueError(f"k must be in [1, 8], got {self.k}")
        if self.d % 32 != 0 or self.d <= 0:
            raise ValueError(f"d must be a positive multiple of 32, got {self.d}")

    @property
    def num_counters(self) -> int:
        """Counters per logical entry: 4^k (reference NUM_COUNTERS)."""
        return 4 ** self.k

    @property
    def num_slim_counters(self) -> int:
        """Counters stored per entry under alternate-counters: 4^k / 2."""
        return self.num_counters // 2

    @property
    def words_per_plane(self) -> int:
        """32-bit words per bit-plane per entry (reference NUM_BITMAPS = d/32)."""
        return self.d // 32

    @property
    def bitmap_words(self) -> int:
        """Total bitmap words per entry: 2 planes x k steps x d/32 windows."""
        return 2 * self.k * self.words_per_plane

    def num_entries(self, bwtsize: int) -> int:
        """ceil(bwtsize / d) (reference src/genFMindex.c:477)."""
        return -(-bwtsize // self.d)

    def entry_bytes(self) -> int:
        """Bytes per entry in the given layout."""
        counters = (
            self.num_slim_counters if self.layout.has_slim_counters else self.num_counters
        )
        return 4 * (self.bitmap_words + counters)


#: device-memory working set of one 1M-read search wave beyond the
#: resident tables: XLA's temp buffers for a k=3 d=192 lut12 wave measured
#: 0.45 GB on an H100, plus the 126 MB query batch, rounded up
SEARCH_WAVE_BYTES = 1 << 30


def device_bytes_limit(device=None) -> int | None:
    """Bytes the device's allocator may hand out (memory_stats()
    'bytes_limit'), or None when the device reports no limit (the CPU)."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def search_bytes(refsize: int, k: int, d: int, lut_m: int) -> int:
    """Device bytes a single-device search needs: the fused entry table
    (E+1 rows of entry_bytes), the 4^lut_m x 2 uint32 prefix LUT, and one
    wave's working set."""
    cfg = IndexConfig(k=k, d=d)
    table = (cfg.num_entries(refsize + 1) + 1) * cfg.entry_bytes()
    lut = 8 * 4**lut_m if lut_m else 0
    return table + lut + SEARCH_WAVE_BYTES


def recommend_config(refsize: int, query_len: int = 120,
                     serving: bool = False,
                     bytes_limit: int | None = None) -> dict:
    """Single-device configuration for a reference of `refsize` bases.

    k: the largest of 3, 2, 1 that divides the query length (the fused
    k-mer round contract). lut_m: the largest m <= 12 with m % k == 0, so
    the LUT removes lut_m/k rounds whenever the read is long enough.

    d is 192, and moves to 320 only when the d=192 table does not fit
    `bytes_limit` (search_bytes; d=320's rows cost about half the bytes
    per base). serving=True opts into the 8.6 GB 15-mer LUT when it
    divides the query length and fits beside the table. Both are
    capacity choices: with bytes_limit None (a device that reports no
    limit) neither is made, and the result is d=192 with lut_m <= 12.
    The ladder's speed on the GPU is not measured yet.

    Returns {'k', 'd', 'lut_m'} kwargs for IndexConfig / XLAEngine.
    """
    # k must divide the query length (the per-round fused k-mer contract,
    # reference src/fmIndexCPUBaseline.c:200).
    k = next((kk for kk in (3, 2, 1) if query_len % kk == 0), 1)
    lut_m = 0
    if query_len >= 24:
        # largest m <= 12 with m % k == 0 (then (query_len - m) % k == 0 too)
        lut_m = 12 - (12 % k)
    d = 192
    if bytes_limit is not None:
        if search_bytes(refsize, k, 192, lut_m) > bytes_limit:
            d = 320
        if (
            serving
            and query_len >= 30
            and 15 % k == 0
            and search_bytes(refsize, k, d, 15) <= bytes_limit
        ):
            lut_m = 15
    return {"k": k, "d": d, "lut_m": lut_m}
