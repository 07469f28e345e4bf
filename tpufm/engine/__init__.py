from tpufm.engine.oracle import search_oracle, lf_step_oracle
from tpufm.engine.xla import XLAEngine, LocateEngine

__all__ = ["search_oracle", "lf_step_oracle", "XLAEngine", "LocateEngine"]


def __getattr__(name):
    # The aligner engines import lazily (they pull in the locate machinery).
    if name == "SearchLocateEngine":
        from tpufm.engine.xla import SearchLocateEngine

        return SearchLocateEngine
    if name == "SeedExtendEngine":
        from tpufm.engine.seed import SeedExtendEngine

        return SeedExtendEngine
    if name == "EditExtendEngine":
        from tpufm.engine.edit import EditExtendEngine

        return EditExtendEngine
    if name == "PairedEndEngine":
        from tpufm.engine.paired import PairedEndEngine

        return PairedEndEngine
    raise AttributeError(name)
