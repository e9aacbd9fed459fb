"""PyTorch workload library: the Llama inference and serving path so far
(see ROADMAP.md for the modules still to port)."""

from .convert import llama_from_jax
from .llama import (
    Llama, LlamaBlock, LlamaConfig, init_llama, llama3_8b, llama_apply,
    llama_generate,
)
from .quant import param_bytes, quantize_llama
from .serving import DecodeServer

__all__ = [
    "Llama", "LlamaBlock", "LlamaConfig", "init_llama", "llama3_8b",
    "llama_apply", "llama_generate", "llama_from_jax",
    "param_bytes", "quantize_llama",
    "DecodeServer",
]
