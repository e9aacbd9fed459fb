"""Whether a serving cell's expert layer waits for the device: one admit
and one eager decode step of the cell's first pod, at the cell's widths,
with ``torch.cuda.set_sync_debug_mode("error")`` set around each call of
the router and expert layer only (``models/moe.py::dropless_moe``), so a
host sync inside it raises; the first token's read stays outside.

    python3 perfbench/syncfree.py --workload trinitymini.reason --seed 7

Then, on the same model: one eager decode step under the profiler, whose
device operations the family's ``expert_kernel`` should find (the routed
experts' grouped products, three an expert layer), and one expert
layer's output against the family's plain reference on 32 tokens.
Prints one JSON line; exits nonzero when a call synced, the kernels
were not found or the layer disagrees.
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--prompt", type=int, default=1000)
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubeshare_tpu_torch.models import afmoe, serving
    from perfbench.lib.catalog import Catalog
    from perfbench.lib.weights import generator
    from perfbench.reference import afmoe_ref
    from perfbench.reference.common import exact_float32

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    catalog = Catalog(REPO / "BENCHMARK.json")
    cell = catalog.cell(args.workload)
    family = catalog.family(cell["config"])
    spec = catalog.spec(cell["config"])
    srv = catalog.traffic(cell["traffic"])["server"]
    model = family.build(spec, args.seed, 0, device, trainable=False)
    server = serving.DecodeServer(
        model, slots=srv["slots"], prompt_buckets=tuple(srv["prompt_buckets"]),
        cuda_graph=False)

    layer = afmoe.dropless_moe
    calls, raised = [], []

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return layer(*a, **k)
        except RuntimeError as e:
            raised.append(str(e).splitlines()[0])
            raise
        finally:
            torch.cuda.set_sync_debug_mode("default")
            calls.append(a[0].shape[0])

    ids = torch.randint(0, spec.vocab, (args.prompt,), device=device,
                        generator=generator(device, args.seed, "prompt"))
    afmoe.dropless_moe = guarded
    try:
        slot, first = server.admit(ids.tolist())
        step = server.step()
    finally:
        afmoe.dropless_moe = layer
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        server.step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    experts = [n for n in names if family.expert_kernel(n)]
    routed = sum(1 for i in range(spec.layers) if spec.routed(i))

    # one expert layer, the program's against the reference, 32 tokens
    block = next(b for b in model.layers if b.routed)
    x = torch.randn(32, spec.dim, device=device,
                    generator=generator(device, args.seed, "x"))
    x = x.to(torch.bfloat16)
    got = afmoe.dropless_moe(
        x, block.router, block.expert_bias, block.experts_gate,
        block.experts_up, block.experts_down, block.slots, spec.top_k,
        spec.route_scale, spec.route_norm,
        shared=(block.shared_gate, block.shared_up, block.shared_down))
    exact_float32()
    w = {n: getattr(block, n).float() for n in afmoe.AfmoeBlock.ROUTED}
    want = afmoe_ref.experts(spec, w, x.float())
    err = ((got.float() - want).norm() / want.norm()).item()

    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device),
           "expert_calls": calls, "raised": raised, "first": first,
           "step_slots": sorted(step), "expert_kernels_a_step": len(experts),
           "expert_kernel_names": sorted({n[:160] for n in experts}),
           "device_ops_a_step": len(names), "routed_layers": routed,
           "layer_rel_err": err, "wall_s": time.perf_counter() - STARTED}
    print(json.dumps(out), flush=True)
    ok = (not raised and len(calls) == 2 * routed
          and len(experts) == 3 * routed and err < 2e-2)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
