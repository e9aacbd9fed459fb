"""The bf16 flash forward kernel's work schedule, on the CPU.

``flash_forward_schedule`` is the work list the host hands
``csrc/flash_fwd.cu`` (encoded by ``flash_work``), and the kernel
walks nothing else: (head, 128-row q tile) items, longest first, dealt in
a snake over a persistent grid of one block per SM, each loading the
128-key tiles its rows can see. These tests hold it to that: every item
exactly once, each block's items longest first and the blocks' work even,
the key range of every item covering each visible key while loading no
tile that no row of the item sees, and the flat list giving each block
its items in order.
"""

import importlib

import pytest

tattn = importlib.import_module("kubeshare_tpu_torch.ops.attention")

BQ, BK = tattn.FLASH_FWD_BLOCK_Q, tattn.FLASH_FWD_BLOCK_K

SHAPES = [
    # B*H, Tq, Tk, causal, window, SMs
    (32, 2048, 2048, True, 0, 132),       # Llama-3-8B, one sequence
    (32, 2048, 2048, False, 0, 132),
    (32, 2048, 2048, True, 1024, 132),
    (128, 2048, 2048, True, 0, 132),      # four sequences
    (32, 4096, 4096, True, 0, 132),
    (8, 17, 17, True, 0, 132),            # a 17-token prompt
    (4, 100, 100, True, 0, 132),          # ragged
    (2, 33, 77, True, 0, 132),            # ragged, Tq < Tk
    (2, 200, 200, True, 37, 132),         # ragged window
    (4, 128, 320, False, 0, 132),
    (64, 512, 512, True, 0, 132),         # more items than SMs
    (3, 1000, 1000, True, 100, 7),        # a small card
]


def _tiles(item):
    _, _, lo, hi = item
    return -(-(hi - lo) // BK)


def _visible_keys(row, t_q, t_k, causal, window):
    """[first, last] of the keys query ``row`` sees."""
    if not causal:
        return 0, t_k - 1
    pos = row + t_k - t_q
    return (max(0, pos - window + 1) if window > 0 else 0), min(pos, t_k - 1)


@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_every_item_exactly_once(bh, t_q, t_k, causal, window, sms):
    blocks = tattn.flash_forward_schedule(bh, t_q, t_k, causal, window, sms)
    n_items = -(-t_q // BQ) * bh
    assert len(blocks) == min(n_items, sms)
    items = [(b, q0) for block in blocks for b, q0, _, _ in block]
    assert sorted(items) == sorted((b, q0) for b in range(bh)
                                   for q0 in range(0, t_q, BQ))
    assert all(block for block in blocks)


@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_longest_first_and_even(bh, t_q, t_k, causal, window, sms):
    """Each block takes its items longest first (under a causal mask with
    no window the later q tiles see more keys), and the snake keeps any
    two blocks' key tiles within one item of each other."""
    blocks = tattn.flash_forward_schedule(bh, t_q, t_k, causal, window, sms)
    lengths = [[_tiles(it) for it in block] for block in blocks]
    if causal and not window:
        for block in lengths:
            assert block == sorted(block, reverse=True)
    totals = [sum(block) for block in lengths]
    assert max(totals) - min(totals) <= max(max(b) for b in lengths)


@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_key_range_covers_visible_keys_only(bh, t_q, t_k, causal, window,
                                            sms):
    blocks = tattn.flash_forward_schedule(bh, t_q, t_k, causal, window, sms)
    for _, q0, lo, hi in (it for block in blocks for it in block):
        spans = [_visible_keys(r, t_q, t_k, causal, window)
                 for r in range(q0, min(q0 + BQ, t_q))]
        assert lo % BK == 0 and 0 <= lo < hi <= t_k
        assert lo <= min(first for first, _ in spans)
        assert hi == max(last for _, last in spans) + 1
        for k0 in range(lo, hi, BK):   # no tile that no row sees
            assert any(first < k0 + BK and last >= k0
                       for first, last in spans), (q0, k0)


@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_work_list_gives_each_block_its_items(bh, t_q, t_k, causal, window,
                                              sms):
    """The flat list: G + 1 offsets, then four ints an item, block after
    block, as the kernel's ``fwd_item`` reads them."""
    blocks = tattn.flash_forward_schedule(bh, t_q, t_k, causal, window, sms)
    flat = tattn.flash_work(blocks)
    grid = len(blocks)
    offsets, items = flat[:grid + 1], flat[grid + 1:]
    assert offsets[0] == 0 and 4 * offsets[-1] == len(items)
    for b, block in enumerate(blocks):
        assert [tuple(items[4 * i:4 * i + 4])
                for i in range(offsets[b], offsets[b + 1])] == block
    assert all(0 <= x < 2 ** 31 for x in flat)   # int32 on the card


def test_llama_8b_reads_half_the_kv_tiles():
    """At the 8B shape (32 heads, T = 2048, causal, D = 128) the kernel
    loads 4,352 K/V tiles of 128 keys, 285 MB of K and V from L2, against
    16,896 tiles of 64 keys (554 MB) with 64-row q tiles and 64-key K/V
    tiles; each of the 132 blocks gets 32 to 34 of them."""
    blocks = tattn.flash_forward_schedule(32, 2048, 2048, True, 0, 132)
    per_block = [sum(_tiles(it) for it in block) for block in blocks]
    assert sum(per_block) == 4352
    assert (min(per_block), max(per_block)) == (32, 34)
    kv_bytes = sum(per_block) * 2 * BK * 128 * 2
    old_tiles = 32 * sum(range(1, 2048 // 64 + 1))
    old_bytes = old_tiles * 2 * 64 * 128 * 2
    assert (kv_bytes, old_tiles, old_bytes) == (285_212_672, 16896,
                                                553_648_128)
