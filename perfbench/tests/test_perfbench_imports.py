"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``kubeshare_tpu`` (top-level names compared whole: the port
``kubeshare_tpu_torch`` begins with it), and the reference, and a
family's module until it builds the program's model, load nothing of
the port either."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "kubeshare_tpu")


def loaded_after(code: str):
    probe = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n{code}\n"
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_whole_tiny_run_loads_no_jax(tmp_path):
    names = loaded_after(
        "from pathlib import Path\n"
        "from perfbench.tests import tiny\n"
        f"b = tiny.checkout(Path({str(tmp_path)!r}))\n"
        "r, _ = tiny.run(b, 'tiny.serve', seconds=0.5)\n"
        "r, _ = tiny.run(b, 'tiny.train', seconds=0.5, trace=True)\n"
        "assert r['correct']")
    assert not names & set(FORBIDDEN)
    assert "kubeshare_tpu_torch" in names


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("import perfbench.reference.llama_ref\n"
                         "import perfbench.reference.common\n"
                         "import perfbench.lib.weights\n"
                         "import perfbench.families.dense")
    assert not names & set(FORBIDDEN + ("kubeshare_tpu_torch",))


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "mistral7b.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
