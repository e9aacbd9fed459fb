"""The harness finds every part of a cell by name: a configuration, a
traffic mix, a cell's limits and a metric added as new files (and
entries in a copy of ``BENCHMARK.json``) are found and used without an
edit to any file that is there. And ``BENCHMARK.json`` keeps to the
shape and limits a benchmark file must keep."""

import json
import re
from pathlib import Path

from perfbench.lib.catalog import Catalog
from perfbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

def snapshot(root: Path):
    return {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

def test_added_files_are_found_without_an_edit(tmp_path):
    bench_path = tiny.checkout(tmp_path)
    home = tmp_path / "perfbench"
    before = snapshot(home)
    # a new metric, as a file of its own, named in a new entry
    (home / "metrics" / "requests_due.py").write_text(
        "def read(run):\n"
        "    if run.kind != 'serve':\n"
        "        return None\n"
        "    w0, w1 = run.window\n"
        "    return float(sum(1 for p in run.pods for r in p.requests\n"
        "                     if w0 <= r.due < w1))\n")
    bench = json.loads(bench_path.read_text())
    bench["per_layer"].append({
        "name": "requests_due", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "Serving: models/serving.py",
        "moves": "decode_tokens_per_s", "workloads": ["tiny.serve"]})
    bench_path.write_text(json.dumps(bench))
    after = snapshot(home)
    changed = [p for p in before if before[p] != after.get(p)]
    assert changed == []          # only files were added

    catalog = Catalog(bench_path)
    assert catalog.spec("tiny").dim == tiny.TINY["hidden_size"]
    assert catalog.traffic("tiny-serve")["kind"] == "serve"
    assert catalog.limits("tiny.serve") == tiny.LIMITS["tiny.serve"]
    names = [m["name"] for m in catalog.metrics("tiny.serve", trace=True)]
    assert "requests_due" in names
    result, _ = tiny.run(bench_path, "tiny.serve", trace=True, seconds=0.6)
    assert result["metrics"]["requests_due"]["value"] == result["attempted"]

# A second model family, added as a file: the dense decoder read from a
# configuration in GPT-2's keys, with its own count of operations (the
# embedding counted as a product).
FAMILY = '''"""The dense decoder, its configuration in GPT-2's keys."""

from perfbench.families import dense

build, loss, program_leaves = dense.build, dense.loss, dense.program_leaves
initial_leaves, attention_calls = dense.initial_leaves, dense.attention_calls
reference_logits = dense.reference_logits
reference_training = dense.reference_training


def spec(name, cfg):
    return dense.ModelSpec(
        name=name, vocab=cfg["vocab_size"], dim=cfg["n_embd"],
        layers=cfg["n_layer"], heads=cfg["n_head"], kv_heads=cfg["n_head_kv"],
        head_dim=cfg["n_embd"] // cfg["n_head"], ff=cfg["n_inner"],
        rope_theta=cfg["rotary_base"], window=cfg["attention_window"],
        eps=cfg["layer_norm_epsilon"], dtype=cfg["dtype"],
        max_positions=cfg["n_positions"])


def forward_flops(spec, first, count):
    embedded = 2.0 * spec.vocab * spec.dim * count
    return embedded + dense.forward_flops(spec, first, count)
'''
GPT_KEYS = {"family": "gpt_keys", "n_embd": 64, "n_layer": 2, "n_head": 4,
            "n_head_kv": 2, "n_inner": 96, "vocab_size": 128,
            "rotary_base": 10000.0, "attention_window": 40,
            "layer_norm_epsilon": 1e-6, "dtype": "bfloat16",
            "n_positions": 256}


def test_a_family_added_as_a_file_runs_serve_and_train_cells(tmp_path):
    import time

    import torch

    from perfbench.families import dense
    from perfbench.lib.harness import compare, measure
    from perfbench.lib.check import verdict
    from perfbench.lib.readers import mfu, traced_flops

    bench_path = tiny.checkout(tmp_path)
    home = tmp_path / "perfbench"
    before = snapshot(home)
    (home / "families" / "gpt_keys.py").write_text(FAMILY)
    (home / "configs" / "tiny-gpt.json").write_text(json.dumps(GPT_KEYS))
    cells = {"tiny-gpt.serve": "tiny-serve", "tiny-gpt.train": "tiny-train"}
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "tiny-gpt", "source": "test",
                             "file": "perfbench/configs/tiny-gpt.json",
                             "reduced": [], "why": "test"})
    for cell, traffic in cells.items():
        twin = cell.replace("tiny-gpt", "tiny")
        (home / "limits" / f"{cell}.json").write_text(
            json.dumps(tiny.LIMITS[twin]))
        bench["workloads"].append({"name": cell, "config": "tiny-gpt",
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if twin in metric.get("workloads", []):
                metric["workloads"].append(cell)
    bench_path.write_text(json.dumps(bench))
    after = snapshot(home)
    assert [p for p in before if before[p] != after.get(p)] == []

    catalog = Catalog(bench_path)
    spec = catalog.spec("tiny-gpt")
    assert spec == dense.spec("tiny-gpt", tiny.TINY)
    cpu = torch.device("cpu")
    for cell in cells:
        session = measure(catalog, cell, 5, 0.8, True, cpu,
                          time.perf_counter(), log=lambda msg: None)
        try:
            numbers = compare(session, 5, cpu)
        finally:
            session.close()
        run = session.run
        assert run.family.__file__ == str(home / "families" / "gpt_keys.py")
        assert verdict(numbers, session.limits), numbers
        assert session.attempted > 0
        if run.kind == "train":
            rows, t = run.traffic["rows"], run.traffic["seq_len"]

            def read(count):
                return mfu(traced_flops(run, "train_step",
                                        lambda span: 3.0 * rows * count), run)

            own = run.family.forward_flops(spec, 0, t)
            assert own > dense.forward_flops(spec, 0, t)
            assert session.metrics["mfu.train"]["value"] == read(own)
        else:
            assert session.metrics["mfu.serve"]["value"] > 0


def test_each_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    catalog = Catalog(REPO / "BENCHMARK.json")
    for cell in BENCH["workloads"]:
        e2e = [m["name"] for m in catalog.metrics(cell["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert catalog.metrics(cell["name"], True)
        catalog.spec(cell["config"])
        traffic = catalog.traffic(cell["traffic"])
        assert traffic["kind"] in ("serve", "train")
        assert catalog.limits(cell["name"])

def test_benchmark_json_keeps_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= BENCH["run_seconds"] <= 51
    full = 24
    assert ((2 + 14 * full) * (BENCH["run_seconds"] + 60) + full * 180
            + 1200) <= 43200
    configs = {c["name"] for c in BENCH["configs"]}
    used = {c["config"] for c in BENCH["workloads"]}
    assert configs == used
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       or k in ("num_experts_per_tok", "num_attention_heads",
                                "num_key_value_heads")
                       for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    cell_names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    cell_names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cell_names
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) <= 64 * 1024

def test_reader_of_a_missing_thing_returns_none():
    catalog = Catalog(REPO / "BENCHMARK.json")

    class Empty:
        kind, trace, pods = "serve", None, []
        window = (0.0, 1.0)

    for m in BENCH["per_layer"]:
        if m["source"] == "device_trace":
            assert catalog.reader(m["name"])(Empty()) is None
