"""Package rules of kubeshare_tpu_torch: it imports neither jax nor the
JAX package, its entry points refuse to run on the CPU unless asked,
the kernel build fails clearly without nvcc, and chip_smoke.py exits
nonzero without a CUDA device."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from kubeshare_tpu_torch.models import llama as tllama
from kubeshare_tpu_torch.models.convert import llama_from_jax
from kubeshare_tpu_torch.ops import _build
from kubeshare_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "kubeshare_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "kubeshare_tpu"}


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_package_imports_with_jax_blocked():
    """Every module imports in a fresh interpreter where importing jax
    or kubeshare_tpu fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'kubeshare_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import kubeshare_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'kubeshare_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'kubeshare_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 12


def test_cluster_subpackage_is_held_to_the_rules():
    """The admission webhook's twin and its label parsing
    (``cluster/``) and its daemon keep their own copies too: listed
    among the checked files, and importable with jax blocked."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for name in ("__init__.py", "labels.py", "webhook.py"):
        assert f"kubeshare_tpu_torch/cluster/{name}" in names
    assert "kubeshare_tpu_torch/cmd/webhook.py" in names
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'kubeshare_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import kubeshare_tpu_torch.cluster as c\n"
        "import kubeshare_tpu_torch.cmd.webhook\n"
        "print(sorted(c.__all__))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "mutate_pod" in out.stdout and "parse_pod" in out.stdout


CFG = tllama.LlamaConfig(vocab=64, dim=32, layers=1, num_heads=2,
                         num_kv_heads=1, mlp_dim=64, max_seq_len=16,
                         dtype="float32")


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: resolve_device(None),
                 lambda: tllama.init_llama(CFG),
                 lambda: tllama.init_kv_cache(CFG, 1),
                 lambda: llama_from_jax({}, CFG)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = tllama.init_llama(CFG, device="cpu")
    assert model.device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_fwd")
    assert not (tmp_path / "kernels").exists()


def test_library_is_keyed_by_its_source():
    path = _build.library_path("flash_fwd")
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path.name.startswith("libflash_fwd-") and path.suffix == ".so"
    assert path == _build.library_path("flash_fwd")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """Without a CUDA device, and in a directory holding chip_smoke.py
    and nothing else of the repo, the script exits nonzero and prints
    no result."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env["PYTHONPATH"] = ""
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
