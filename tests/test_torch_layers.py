"""kubeshare_tpu_torch/models/common.py's layers (dense, conv, the max
pools, layernorm) against kubeshare_tpu/models/common.py on the same
numpy inputs and weights, on the CPU.

The reference computes NHWC with HWIO weights and [in, out] dense
weights; the port NCHW with OIHW and [out, in], carried across by
transposes. Tolerances, on the max abs difference over the reference's
max abs: float32 (the API's ``dtype=float32``) 1e-5, the same float32
products summed in another order; bf16 (the default) 1e-2, about two
bf16 ulps (2^-8 relative), for a product rounded to bf16 and a bias
added in bf16 in either framework.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kubeshare_tpu.models import common as jcommon
from kubeshare_tpu_torch.models import common as tcommon

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def _conv_layer(w: np.ndarray, b: np.ndarray) -> tcommon.Conv:
    return tcommon.Conv(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                        torch.from_numpy(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_reference(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 40)).astype(np.float32) / 7
    b = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    want = jcommon.dense({"w": w, "b": b}, jnp.asarray(x),
                         getattr(jnp, dtype))
    layer = tcommon.Dense(torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    got = tcommon.dense(layer, torch.from_numpy(x), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (3, 5, 40)
    assert _rel(got, want) <= TOL[dtype]


# (kernel, stride, size): odd and even sizes, so XLA's SAME split of an
# odd total padding (the larger half after) shows
CONV_CASES = [(k, s, h) for k in (1, 3, 7) for s in (1, 2) for h in (9, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,size", CONV_CASES)
def test_conv_same_padding_matches_reference(kernel, stride, size, dtype):
    rng = np.random.default_rng(kernel * 100 + stride * 10 + size)
    w = rng.standard_normal((kernel, kernel, 3, 4)).astype(np.float32) / 3
    b = rng.standard_normal(4).astype(np.float32)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    want = jcommon.conv({"w": w, "b": b}, jnp.asarray(x), stride,
                        getattr(jnp, dtype))
    got = tcommon.conv(_conv_layer(w, b), _nchw(x), stride,
                       getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert _nhwc(got).shape == want.shape
    assert _rel(_nhwc(got), want) <= TOL[dtype]


def test_symmetric_padding_is_not_same_at_stride_2():
    """ResNet's 7x7/2 stem on 32 x 32: XLA pads (2, 3), PyTorch's
    symmetric ``padding=3`` pads (3, 3) and gives another answer."""
    assert tcommon.same_padding(32, 7, 2) == (2, 3)
    rng = np.random.default_rng(1)
    w = rng.standard_normal((7, 7, 3, 4)).astype(np.float32)
    b = np.zeros(4, np.float32)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    want = jcommon.conv({"w": w, "b": b}, jnp.asarray(x), 2, jnp.float32)
    layer = _conv_layer(w, b)
    symmetric = F.conv2d(_nchw(x), layer.w, stride=2, padding=3)
    assert _nhwc(symmetric).shape == want.shape
    assert _rel(_nhwc(symmetric), want) > 0.1
    got = tcommon.conv(layer, _nchw(x), 2, torch.float32)
    assert _rel(_nhwc(got), want) <= TOL["float32"]


@pytest.mark.parametrize("size", [7, 8, 15, 16])
def test_max_pools_match_reference(size):
    """The VALID 2x2 pool and ResNet's SAME 3x3/2 stem pool (padded with
    -inf on XLA's sides), exact."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32) - 3.0
    for window, stride, padding, same in ((2, 2, "VALID", False),
                                          (3, 2, "SAME", True)):
        want = jax.lax.reduce_window(
            jnp.asarray(x), -jnp.inf, jax.lax.max, (1, window, window, 1),
            (1, stride, stride, 1), padding)
        got = tcommon.max_pool(_nchw(x), window, stride, same)
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_layernorm_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 6, 32)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    want = jcommon.layernorm({"scale": scale, "bias": bias}, jnp.asarray(x))
    layer = tcommon.Norm(torch.from_numpy(scale), torch.from_numpy(bias))
    got = tcommon.layernorm(layer, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    want_bf16 = jcommon.layernorm({"scale": scale, "bias": bias},
                                  jnp.asarray(x).astype(jnp.bfloat16))
    assert _rel(got, want_bf16) <= TOL["float32"]
    got = tcommon.layernorm(layer, torch.from_numpy(x))
    assert _rel(got, want) <= TOL["float32"]
    init = tcommon.layernorm_init(32, device="cpu")
    assert torch.equal(init.scale, torch.ones(32))
    assert torch.equal(init.bias, torch.zeros(32))


def test_inits_draw_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    dense = tcommon.dense_init(400, 300, gen, scale=2.0)
    assert dense.w.shape == (300, 400) and not dense.b.any()
    assert abs(dense.w.std().item() - 2.0 / 20) < 0.002
    conv = tcommon.conv_init(3, 3, 50, 64, gen)
    assert conv.w.shape == (64, 50, 3, 3) and not conv.b.any()
    assert abs(conv.w.std().item() - (2.0 / 450) ** 0.5) < 0.002
    with pytest.raises(ValueError, match="generator is on"):
        tcommon.init_generator(gen, "meta")
