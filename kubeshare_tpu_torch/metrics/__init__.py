"""The node's device inventory (``tpu_capacity``) and the scrapes the
node side reads (ports of ``kubeshare_tpu/metrics/{collector,scrape}.py``;
the aggregator belongs to the control plane and is not ported)."""

from .collector import (
    ChipInfo,
    Collector,
    FakeChipBackend,
    NvmlChipBackend,
    SubcoreBackend,
    split_subcores,
)
from .scrape import scrape_capacity, scrape_requirements

__all__ = [
    "ChipInfo",
    "Collector",
    "FakeChipBackend",
    "NvmlChipBackend",
    "SubcoreBackend",
    "split_subcores",
    "scrape_capacity",
    "scrape_requirements",
]
