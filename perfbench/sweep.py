"""Find a serving cell's knee: the highest per-pod arrival rate its pods
sustain without a growing queue.

    python3 perfbench/sweep.py --workload <cell> --seed 7 --rates 1.5,2,2.5,3 --seconds 20

One set-up (the cell's pods, warmed), then each rate in turn: every pod
gets the cell's traffic at that rate from a clean pool and serves it for
the pre-roll and ``--seconds``. A JSON line a rate: tokens delivered a
second, TTFT p50 and p95 over the requests due in the window, and the
requests due but not yet admitted at the window's middle and at its end
(a queue that grows from one to the other is past the knee). The knee
goes into the cell's traffic file by hand, as a number.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def waiting(reqs, t: float) -> int:
    return sum(1 for r in reqs if r.due <= t and r.first > t)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    args = parser.parse_args(argv)

    import torch

    from perfbench.lib import traffic as TR
    from perfbench.lib.catalog import Catalog
    from perfbench.lib.harness import _threads
    from perfbench.lib.pods import Arbiter, ServePod
    from perfbench.lib.readers import percentile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    catalog = Catalog(REPO / "BENCHMARK.json")
    cell = catalog.cell(args.workload)
    family = catalog.family(cell["config"])
    spec = catalog.spec(cell["config"])
    base = catalog.traffic(cell["traffic"])
    names = [f"{args.workload}/pod-{i}" for i in range(int(base["pods"]))]
    arbiter = Arbiter(names, base)
    pods = []
    try:
        for i, name in enumerate(names):
            pods.append(ServePod(i, name, arbiter.gate(name), device, family,
                                 spec, base, args.seed, args.seconds, False))
        for pod in pods:
            pod.warm_up()
        torch.cuda.synchronize()
        print(json.dumps({"setup_s": time.perf_counter() - STARTED}),
              flush=True)
        for rate in (float(r) for r in args.rates.split(",")):
            traffic = copy.deepcopy(base)
            traffic["arrivals"]["rate_per_pod"] = rate
            for pod in pods:
                pod.requests = TR.requests(traffic, args.seed, pod.index,
                                           TR.horizon(traffic, args.seconds))
                pod.finished = []
            start = time.perf_counter() + 0.01
            w0 = start + float(traffic.get("preroll_s", 0.0))
            w1 = w0 + args.seconds
            threads, errors = _threads([(lambda p=p: p.loop(start, w1))
                                        for p in pods])
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            for pod in pods:
                for slot in range(pod.server.slots):
                    if pod.server.active[slot]:
                        pod.server.retire(slot)
            reqs = [r for p in pods for r in p.requests]
            due = [r for r in reqs if w0 <= r.due < w1]
            ttft = [min(r.first, w1) - r.due for r in due]
            tokens = sum(n for r in reqs for t, n in r.deliveries
                         if w0 <= t < w1)
            print(json.dumps({
                "rate_per_pod": rate, "due": len(due),
                "tokens_per_s": tokens / args.seconds,
                "ttft_p50_ms": 1e3 * percentile(ttft, 50),
                "ttft_p95_ms": 1e3 * percentile(ttft, 95),
                "waiting_mid": waiting(reqs, w0 + args.seconds / 2),
                "waiting_end": waiting(reqs, w1),
                "finished": sum(len(p.finished) for p in pods)}), flush=True)
    finally:
        for pod in pods:
            pod.gate.close()
        arbiter.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
