"""kubeshare_tpu_torch: the workload side of kubeshare_tpu in PyTorch and
CUDA, for NVIDIA Hopper (H100).

The JAX package ``kubeshare_tpu`` is the reference; this package mirrors
its layout module for module (``ops/attention.py``, ``models/llama.py``,
``models/serving.py``, ``runtime/hook.py`` ...) so each port sits where
a reader expects its counterpart. It imports ``torch`` and numpy, never
``jax`` and nothing of ``kubeshare_tpu``: where it needs code of a
jax-free module there, it keeps its own copy.

Devices: entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (utils/device.py). Every Pallas kernel of the reference
on a ported path is a hand-written CUDA kernel here (``ops/csrc``); its
plain PyTorch version beside it runs only for tensors on the CPU.
"""

__version__ = "0.1.0"
