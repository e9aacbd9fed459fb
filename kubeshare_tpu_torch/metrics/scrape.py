"""Consume capacity and requirement endpoints (a copy of
``kubeshare_tpu/metrics/scrape.py``).

The config daemon and the scheduler's inventory accept either a
component's own URL or a Prometheus server's: a Prometheus in the
middle is an optimisation, not a dependency.
"""

from __future__ import annotations

import urllib.request
from typing import Dict, List

from ..utils import expfmt
from .collector import CAPACITY_METRIC, ChipInfo

# the aggregator's per-pod series (kubeshare_tpu/metrics/aggregator.py),
# which the node config daemon turns into per-device files
REQUIREMENT_METRIC = "tpu_requirement"


def fetch(url: str, timeout: float = 5.0) -> List[expfmt.Sample]:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return expfmt.parse(resp.read().decode())


def capacity_from_samples(
    samples: List[expfmt.Sample],
) -> Dict[str, List[ChipInfo]]:
    """Group ``tpu_capacity`` samples into per-node inventories."""
    by_node: Dict[str, List[ChipInfo]] = {}
    for s in expfmt.select(samples, CAPACITY_METRIC):
        labels = s.labels
        try:
            chip = ChipInfo(
                uuid=labels["uuid"],
                model=labels["model"],
                memory=int(labels["memory"]),
                index=int(labels.get("index", "0")),
                parent=labels.get("parent", ""),
            )
        except (KeyError, ValueError):
            continue
        by_node.setdefault(labels.get("node", ""), []).append(chip)
    for chips in by_node.values():
        chips.sort(key=lambda c: c.index)
    return by_node


def scrape_capacity(url: str, timeout: float = 5.0) -> Dict[str, List[ChipInfo]]:
    return capacity_from_samples(fetch(url, timeout))


def scrape_requirements(
    url: str, node: str = "", timeout: float = 5.0
) -> List[expfmt.Sample]:
    samples = expfmt.select(fetch(url, timeout), REQUIREMENT_METRIC)
    if node:
        samples = [s for s in samples if s.labels.get("node") == node]
    return samples
