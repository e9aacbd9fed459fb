"""The flash kernels' least time is counted at the model's own head dim
(96 for Phi-3), and the dense family's operations, against counts made
by hand."""

import pytest

from perfbench.families import dense
from perfbench.lib import roofline as R


def test_visible_pairs_with_the_window_by_hand():
    # T 2048, window 2047: query i sees i + 1 keys up to 2047, then 2047
    assert R.visible_pairs(2048, 2048, True, 2047) == 2047 * 2048 // 2 + 2047
    assert R.visible_pairs(4, 4, True, 0) == 10
    assert R.visible_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert R.visible_pairs(3, 5, False, 0) == 15


@pytest.mark.parametrize("kind,per_pair,q_like,k_like,rows", [
    ("fwd", 4, 2, 2, 1), ("bwd_dq", 6, 3, 2, 2), ("bwd_dkv", 8, 2, 4, 2)])
def test_flash_bound_at_head_dim_96_by_hand(kind, per_pair, q_like, k_like,
                                            rows):
    b, h, hkv, t, d = 4, 32, 32, 2048, 96
    pairs = 2047 * 2048 // 2 + 2047
    ops = per_pair * b * h * d * pairs
    n_bytes = 2 * d * (q_like * b * h * t + k_like * b * hkv * t) \
        + 4 * rows * b * h * t
    want = max(ops / 989e12, n_bytes / 3.35e12)
    got = R.flash_bound_s((b, h, hkv, t, t, d), "bfloat16", True, 2047, kind)
    assert got == pytest.approx(want, rel=1e-12)
    # the padded dim would credit a third more operations
    padded = R.flash_bound_s((b, h, hkv, t, t, 128), "bfloat16", True, 2047,
                             kind)
    assert padded == pytest.approx(want * 128 / 96, rel=1e-9)


def test_model_operations_by_hand():
    spec = dense.ModelSpec("x", vocab=10, dim=8, layers=2, heads=2, kv_heads=1,
                     head_dim=4, ff=12, rope_theta=1e4, window=3, eps=1e-6,
                     dtype="bfloat16", max_positions=64)
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 12
    assert spec.matmul_params() == 2 * per_layer + 10 * 8
    # positions 0..4 see 1, 2, 3, 3, 3 keys
    attn = 4 * 2 * 2 * 4 * (1 + 2 + 3 + 3 + 3)
    assert dense.forward_flops(spec, 0, 5) == (2 * spec.matmul_params() * 5
                                               + attn)
    assert dense.attention_flops(spec, 3, 2) == 4 * 2 * 2 * 4 * (3 + 3)
