"""The benchmark's own tests (``python -m pytest perfbench/tests``). The
``cuda`` marker is the repo's: a test that needs the card is marked and
decides inside itself whether there is one."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")
