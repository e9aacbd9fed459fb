"""The tiny cells on the card: CUDA graphs, streams, the profiler's
device trace and every reader. Run on the chip with
``python -m pytest -m cuda perfbench/tests``."""

import pytest
import torch

from perfbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny.serve", "tiny.train"])
def test_tiny_cell_on_the_card(tmp_path, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from perfbench.lib.catalog import Catalog
    from perfbench.lib.harness import run_cell

    bench = tiny.checkout(tmp_path)
    result, lines = run_cell(Catalog(bench), workload, 3, 1.5, True,
                             torch.device("cuda", 0), time.perf_counter(),
                             log=lambda m: None)
    assert result["correct"], lines
    assert result["device"]["busy_s"] > 0
    assert result["breakdown"]["device_ops"]
