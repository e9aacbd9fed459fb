"""PyTorch workload library (port of ``kubeshare_tpu/models``): the
reference's test-container workloads (MNIST, CIFAR-10, VGG, ResNet,
LSTM) and the Llama inference, serving and training path. Models are
``nn.Module``s built from explicit ``torch.Generator``s on an explicit
device, and the MoE FFN (see ROADMAP.md for the modules still to
port)."""

from .checkpoint import (
    AsyncCheckpointManager, latest_checkpoint, restore_checkpoint,
    save_checkpoint,
)
from .cifar import CifarConfig, cifar_apply, init_cifar
from .convert import (
    cifar_from_jax, llama_from_jax, llama_to_jax, lstm_from_jax,
    mnist_from_jax, moe_from_jax, moe_to_jax, resnet_from_jax,
    stacked_layers_from_jax, stacked_layers_to_jax, vgg_from_jax,
    workload_to_jax,
)
from .data import Prefetcher, prefetch_to_device
from .llama import (
    Llama, LlamaBlock, LlamaConfig, init_llama, llama3_8b, llama_apply,
    llama_generate, llama_loss, llama_pipeline_hidden, llama_stack_layers,
    make_llama_sp_loss,
)
from .lstm import LstmConfig, init_lstm, lstm_apply
from .mnist import MnistConfig, init_mnist, make_mnist_train_step, mnist_apply
from .moe import MoeConfig, init_moe_ffn, moe_ffn_apply, moe_param_spec
from .quant import param_bytes, quantize_llama
from .resnet import ResNetConfig, init_resnet, resnet50, resnet_apply
from .serving import DecodeServer
from .train import make_train_step, synthetic_batches
from .vgg import VggConfig, init_vgg, vgg16, vgg_apply

__all__ = [
    "MnistConfig", "init_mnist", "mnist_apply", "make_mnist_train_step",
    "CifarConfig", "init_cifar", "cifar_apply",
    "LstmConfig", "init_lstm", "lstm_apply",
    "ResNetConfig", "init_resnet", "resnet_apply", "resnet50",
    "VggConfig", "init_vgg", "vgg_apply", "vgg16",
    "Llama", "LlamaBlock", "LlamaConfig", "init_llama", "llama3_8b",
    "llama_apply", "llama_generate", "llama_loss", "make_llama_sp_loss",
    "llama_pipeline_hidden", "llama_stack_layers",
    "MoeConfig", "init_moe_ffn", "moe_ffn_apply", "moe_param_spec",
    "llama_from_jax", "llama_to_jax", "mnist_from_jax", "cifar_from_jax",
    "vgg_from_jax", "resnet_from_jax", "lstm_from_jax", "workload_to_jax",
    "moe_from_jax", "moe_to_jax", "stacked_layers_from_jax",
    "stacked_layers_to_jax",
    "param_bytes", "quantize_llama",
    "DecodeServer",
    "Prefetcher", "prefetch_to_device",
    "save_checkpoint", "latest_checkpoint", "restore_checkpoint",
    "AsyncCheckpointManager",
    "make_train_step", "synthetic_batches",
]
