"""The port's workload models (models/{mnist,cifar,vgg,resnet,lstm}.py)
against the JAX package on the CPU: a parameter tree in the reference's
structure (``jax.eval_shape`` of its init) filled from a numpy seed,
biases and norm shifts nonzero, given to the reference as it is and to
the port through models/convert.py, and the same numpy inputs (NHWC for
the reference, NCHW for the port).

Tolerances, on the max abs difference over the reference's max abs:
- logits (bf16 in both): 5e-2, a few bf16 ulps (2^-8 relative each)
  where the two frameworks round differently (XLA may keep excess
  precision between fused ops), carried through up to 18 layers and
  group norms (the ResNets move most, ~1e-2 here and up to 2.4e-2 over
  six seeds; the models without norms agree bit for bit today);
- one MNIST SGD step at lr 0.1, each leaf's update over its max abs
  update: weights 1e-2 (~6.5e-3 here); biases 0.25. A bias's gradient
  is a sum over the batch and every position of bf16 cotangents, which
  the two frameworks accumulate differently (conv1's bias, 6272 terms,
  moves most: ~5e-2 here, ~0.12 with other weights);
- the float32 loss of those bf16 logits: 5e-3 relative (a logit an ulp
  off moves it by up to 2^-8 of that logit);
- one Adam step of CIFAR at lr 1e-3 (float32 loss, as
  ``common.cross_entropy_loss``), the parameters: 1e-5 absolute, 1 % of
  the step Adam takes (lr, whatever the gradient's size), except on at
  most 1 % of a leaf's elements, held to 2 lr + 1e-5: Adam's first step
  is lr g / (|g| + eps), so a gradient within rounding of zero may flip
  sign (one element of 216 in a bias here, as in
  tests/test_torch_train.py's three Adam steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeshare_tpu.models as J
from kubeshare_tpu.models.common import cross_entropy_loss as j_xent
from kubeshare_tpu.models.train import make_train_step as j_make_train_step
from kubeshare_tpu_torch.models import common as tcommon
from kubeshare_tpu_torch.models import convert
from kubeshare_tpu_torch.models import train as ttrain
import kubeshare_tpu_torch.models as T

LOGIT_TOL = 5e-2
LOSS_TOL = 5e-3
SGD_UPDATE_TOL = {"w": 1e-2, "b": 0.25}
ADAM_ABS_TOL = 1e-5
ADAM_FLIP_SHARE = 1e-2


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tree(j_init, jcfg, seed: int):
    """The reference init's tree structure and shapes, numpy values from
    ``seed``: He-scaled weights, and biases, norm scales and shifts that
    are not the init's zeros and ones, so every leaf matters."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: j_init(key, jcfg),
                            jax.random.PRNGKey(0))

    def leaf(path, shape):
        name = path[-1].key
        x = rng.standard_normal(shape.shape).astype(np.float32)
        if name == "w":
            return x * np.float32(np.sqrt(2.0 / np.prod(shape.shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "table":
            return 0.5 * x
        return 0.1 * x                      # "b", "bias"

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _port_cfg(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


# the CLI's CIFAR-scale VGG (kubeshare_tpu/cmd/workload.py)
CLI_VGG = dict(layers=(32, "M", 64, "M", 128, "M", 256, "M", 256, "M"),
               num_classes=10, classifier_width=256, image_size=32)

IMAGE_MODELS = {
    "mnist_cnn": (J.MnistConfig(hidden=32), J.init_mnist, J.mnist_apply,
                  T.MnistConfig, convert.mnist_from_jax, (28, 28, 1)),
    "mnist_mlp": (J.MnistConfig(arch="mlp", hidden=32), J.init_mnist,
                  J.mnist_apply, T.MnistConfig, convert.mnist_from_jax,
                  (28, 28, 1)),
    "cifar": (J.CifarConfig(widths=(8, 16, 32), hidden=32), J.init_cifar,
              J.cifar_apply, T.CifarConfig, convert.cifar_from_jax,
              (32, 32, 3)),
    "vgg_cli": (J.VggConfig(**CLI_VGG), J.init_vgg, J.vgg_apply,
                T.VggConfig, convert.vgg_from_jax, (32, 32, 3)),
    # two pools: an fc1 that reads a 2 x 2 map, so its rows are permuted
    "vgg_2x2": (J.VggConfig(layers=(8, "M", 16, "M"), num_classes=10,
                            classifier_width=32, image_size=64),
                J.init_vgg, J.vgg_apply, T.VggConfig, convert.vgg_from_jax,
                (8, 8, 3)),
    # 64 x 64: at 32 x 32 the last stage's map is 1 x 1 and its group
    # norm normalises pairs of values, which turns a bf16 ulp into
    # anything (up to 0.45 of the max abs over six seeds)
    "resnet18_narrow": (J.ResNetConfig(width=8, num_classes=10),
                        J.init_resnet, J.resnet_apply, T.ResNetConfig,
                        convert.resnet_from_jax, (64, 64, 3)),
    "resnet_bottleneck": (J.ResNetConfig(stage_sizes=(1, 2), width=8,
                                         num_classes=10, bottleneck=True),
                          J.init_resnet, J.resnet_apply, T.ResNetConfig,
                          convert.resnet_from_jax, (33, 33, 3)),
}


@pytest.mark.parametrize("name", sorted(IMAGE_MODELS))
def test_image_model_logits_match_reference(name):
    jcfg, j_init, j_apply, t_cfg, from_jax, shape = IMAGE_MODELS[name]
    params = _tree(j_init, jcfg, len(name))
    x = np.random.default_rng(0).standard_normal((3,) + shape).astype(
        np.float32)
    want = jax.jit(j_apply, static_argnums=2)(params, jnp.asarray(x), jcfg)
    model = from_jax(params, _port_cfg(t_cfg, jcfg), device="cpu")
    got = model(_nchw(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= LOGIT_TOL
    # and back: the reference's tree, bit for bit
    back = convert.workload_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_lstm_logits_match_reference():
    jcfg = J.LstmConfig(vocab=64, dim=16, hidden=32, layers=2)
    params = _tree(J.init_lstm, jcfg, 4)
    tokens = np.random.default_rng(1).integers(0, 64, (3, 9)).astype(
        np.int32)
    want = jax.jit(J.lstm_apply, static_argnums=2)(
        params, jnp.asarray(tokens), jcfg)
    model = convert.lstm_from_jax(params, _port_cfg(T.LstmConfig, jcfg),
                                  device="cpu")
    got = T.lstm_apply(model, torch.from_numpy(tokens).long())
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= LOGIT_TOL


def test_port_inits_build_the_reference_tree():
    """Each init builds the reference's keys and shapes (in the port's
    layouts), so a converted tree and an initialised model agree."""
    for jcfg, j_init, _, t_cfg, _, _ in IMAGE_MODELS.values():
        init = {J.MnistConfig: T.init_mnist, J.CifarConfig: T.init_cifar,
                J.VggConfig: T.init_vgg,
                J.ResNetConfig: T.init_resnet}[type(jcfg)]
        model = init(_port_cfg(t_cfg, jcfg), device="cpu")
        ours = jax.tree.map(np.shape, convert.workload_to_jax(model))
        theirs = jax.tree.map(lambda a: a.shape, jax.eval_shape(
            lambda key: j_init(key, jcfg), jax.random.PRNGKey(0)))
        assert ours == theirs


def test_mnist_sgd_step_matches_reference():
    jcfg = J.MnistConfig(hidden=32)
    params = _tree(J.init_mnist, jcfg, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    j_after, j_loss = J.make_mnist_train_step(jcfg, lr=0.1)(
        params, jnp.asarray(x), jnp.asarray(y))
    model = convert.mnist_from_jax(params, T.MnistConfig(hidden=32),
                                   device="cpu")
    step = T.make_mnist_train_step(model, lr=0.1)
    loss = step(_nchw(x), torch.from_numpy(y).long())
    assert abs(loss.item() - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
    got = convert.workload_to_jax(model)
    for layer in params:
        for leaf in params[layer]:
            before = params[layer][leaf]
            want = np.asarray(j_after[layer][leaf]) - before
            assert (_rel(got[layer][leaf] - before, want)
                    <= SGD_UPDATE_TOL[leaf]), (layer, leaf)


def test_cifar_adam_step_matches_optax():
    jcfg = J.CifarConfig(widths=(8, 16), hidden=32)
    params = _tree(J.init_cifar, jcfg, 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    opt, j_step = j_make_train_step(
        lambda p, a, b: j_xent(J.cifar_apply(p, a, jcfg), b),
        learning_rate=1e-3)
    j_after, _, j_loss = j_step(params, opt.init(params), jnp.asarray(x),
                                jnp.asarray(y))
    model = convert.cifar_from_jax(params, _port_cfg(T.CifarConfig, jcfg),
                                   device="cpu")
    _, step = ttrain.make_train_step(
        lambda m, a, b: tcommon.cross_entropy_loss(T.cifar_apply(m, a), b),
        model, 1e-3)
    loss = step(_nchw(x), torch.from_numpy(y).long())
    assert abs(loss.item() - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
    got = convert.workload_to_jax(model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(j_after)):
        diff = np.abs(a - np.asarray(b))
        assert (diff > ADAM_ABS_TOL).mean() <= ADAM_FLIP_SHARE
        assert diff.max() <= 2 * 1e-3 + ADAM_ABS_TOL


def test_mnist_step_is_eager_on_the_cpu():
    model = T.init_mnist(T.MnistConfig(hidden=16), device="cpu")
    step = T.make_mnist_train_step(model, lr=0.1)
    images = torch.randn(4, 1, 28, 28, generator=torch.Generator()
                         .manual_seed(0))
    labels = torch.tensor([1, 2, 3, 4])
    before = [p.detach().clone() for p in model.parameters()]
    losses = [step(images, labels).item() for _ in range(5)]
    assert losses[-1] < losses[0]
    assert all(not torch.equal(a, b)
               for a, b in zip(before, model.parameters()))
    assert not hasattr(step, "inputs")      # no CUDA graph on the CPU
