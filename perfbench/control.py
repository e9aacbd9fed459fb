"""The check's control and faults, read on the chip at a cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 20

For each seed, one run of the cell (set-up and a window of ``--seconds``
at the cell's load), then, once the program's state is freed:
- serving: the program's ``serve_gap`` and the control's, the
  reference computed with every product's operands rounded to float8
  (e4m3, a scale per row: the precision below the configurations'
  bfloat16) put in the program's place: at each served position the
  token the control puts first, and its gap below the float32
  reference's best;
- training (its readings need no window): the program's three numbers
  for each pod, the float8 control's and a planted fault's for pod 0:
  the reference trained on half of each batch, its mean over the rest.
  (A step that leaves the state unchanged reads 1 on ``change_gap`` by
  the measure's definition and needs no run.)
One JSON line a seed; the limits in ``limits/<cell>.json`` are set from
these readings and the benchmark's own runs (PERF.md says how).
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def serve_readings(session, seed, device):
    import torch

    from perfbench.lib import check
    from perfbench.reference.common import fp8

    run = session.run
    gaps = {"serve_gap": 0.0, "control_gap": 0.0}
    for pod in sorted({p for p, _ in session.chosen}):
        reqs = [r for p, r in session.chosen if p == pod]
        ref = check.reference_logits(run.family, run.spec, seed, pod, reqs,
                                     device)
        ctl = check.reference_logits(run.family, run.spec, seed, pod, reqs,
                                     device, quant=fp8)
        for r, want, low in zip(reqs, ref, ctl):
            served = torch.tensor(r.tokens, dtype=torch.long, device=device)
            gaps["serve_gap"] = max(gaps["serve_gap"],
                                    check.widest_gap(want, served))
            gaps["control_gap"] = max(gaps["control_gap"], check.widest_gap(
                want, low.argmax(dim=-1)))
    gaps["tokens"] = sum(len(r.tokens) for _, r in session.chosen)
    gaps["requests"] = len(session.chosen)
    return gaps


def train_readings(session, seed, device):
    from perfbench.lib import check
    from perfbench.reference.common import fp8

    run = session.run
    out = {"program": []}
    for pod in run.pods:
        ref = check.reference_training(run.family, run.spec, run.traffic,
                                       seed, pod.index, device)
        out["program"].append(check.train_numbers(
            session.readings[pod.index], ref))
        if pod.index == 0:
            ctl = check.reference_training(run.family, run.spec, run.traffic,
                                           seed, 0, device, quant=fp8)
            out["control"] = check.train_numbers(ctl, ref)
            half = check.reference_training(
                run.family, run.spec, run.traffic, seed, 0, device,
                rows_used=run.traffic["rows"] // 2)
            out["half_batch"] = check.train_numbers(half, ref)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args(argv)

    import torch

    from perfbench.lib.catalog import Catalog
    from perfbench.lib.harness import measure
    from perfbench.reference.common import exact_float32

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    catalog = Catalog(REPO / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        started = time.perf_counter()
        session = measure(catalog, args.workload, seed, args.seconds, False,
                          device, started, log=lambda m: None)
        try:
            exact_float32()
            readings = (serve_readings(session, seed, device)
                        if session.run.kind == "serve"
                        else train_readings(session, seed, device))
        finally:
            session.close()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "limits": session.limits, **readings,
                          "wall_s": time.perf_counter() - started}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
