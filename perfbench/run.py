"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m perfbench.run`` works too).
Prints each compared number beside its limit as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; ``checks`` last. Exits nonzero,
printing no result, without the CUDA devices the cell asks for, or when
``jax``, ``jaxlib``, ``flax`` or ``kubeshare_tpu`` (whole top-level
names) is loaded once the window has closed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program inside the checkout, at
# fixed paths, so only a checkout's first run builds
CACHE = REPO / "build" / "perfbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "kubeshare_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from perfbench.lib.catalog import Catalog
    from perfbench.lib.harness import run_cell

    catalog = Catalog(REPO / "BENCHMARK.json")
    chips = int(catalog.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result, lines = run_cell(catalog, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             STARTED, log)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package loaded: {loaded}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
