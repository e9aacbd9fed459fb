"""The bf16 flash backward kernels' work schedules, on the CPU.

The host hands ``csrc/flash_bwd.cu`` two work lists (encoded by
``flash_work``), and the kernels walk nothing else:

- dq: the forward's items (head, 128-row q tile), with key tiles of
  FLASH_DQ_BLOCK_K (``flash_forward_schedule(block_k=...)``);
- dk/dv: (kv head, 128-key tile, one query head r of the group) items
  with the 64-row q tiles that can see the key tile
  (``flash_backward_schedule``). Item (tile, r) adds its part of the
  group's sum after item (tile, r - 1) and waits for it on the card, so
  the kernel is free of deadlock only if every block walks its items in
  list order and each wait points to an earlier item.

These tests hold both lists to that: every item exactly once, each
item's range covering every visible pair and loading no tile that no
pair sees, the blocks' work even to within one item, each block's items
in list order, (tile, r) before (tile, r + 1), a simulated run of the
waits that always finishes, and the flat int32 encoding.
"""

import importlib

import pytest

tattn = importlib.import_module("kubeshare_tpu_torch.ops.attention")

DQ_BQ, DQ_BK = tattn.FLASH_FWD_BLOCK_Q, tattn.FLASH_DQ_BLOCK_K
KV_BQ, KV_BK = tattn.FLASH_DKV_BLOCK_Q, tattn.FLASH_DKV_BLOCK_K

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
# query heads per kv head: none shared, Llama-3-8B's 4, a group of 8
REPS = [1, 4, 8]


def _visible_keys(row, t_q, t_k, causal, window):
    """[first, last] of the keys query ``row`` sees."""
    if not causal:
        return 0, t_k - 1
    pos = row + t_k - t_q
    return (max(0, pos - window + 1) if window > 0 else 0), min(pos, t_k - 1)


def _sees(row, k_first, k_last, t_q, t_k, causal, window):
    first, last = _visible_keys(row, t_q, t_k, causal, window)
    return first <= k_last and last >= k_first


def _kv_heads(bh, reps):
    """B*Hkv for a shape with about ``bh`` query heads in groups of
    ``reps``."""
    return max(1, bh // reps)


def _dkv(bh, reps, t_q, t_k, causal, window, sms):
    return tattn.flash_backward_schedule(_kv_heads(bh, reps), reps, t_q, t_k,
                                         causal, window, sms)


def _q_tiles(item):
    _, _, _, lo, hi = item
    return -(-(hi - lo) // KV_BQ)


# ---- dq: the forward's items with FLASH_DQ_BLOCK_K-key tiles -----------

@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_dq_every_item_once_and_key_range(bh, t_q, t_k, causal, window,
                                          sms):
    """dq's items: each (head, q tile) once, its 64-key tiles aligned,
    covering every key a row sees and none that no row sees."""
    blocks = tattn.flash_forward_schedule(bh, t_q, t_k, causal, window, sms,
                                          DQ_BK)
    items = [it for block in blocks for it in block]
    assert sorted((b, q0) for b, q0, _, _ in items) == sorted(
        (b, q0) for b in range(bh) for q0 in range(0, t_q, DQ_BQ))
    for _, q0, lo, hi in items:
        spans = [_visible_keys(r, t_q, t_k, causal, window)
                 for r in range(q0, min(q0 + DQ_BQ, t_q))]
        assert lo % DQ_BK == 0 and 0 <= lo < hi <= t_k
        assert lo <= min(first for first, _ in spans)
        assert hi == max(last for _, last in spans) + 1
        for k0 in range(lo, hi, DQ_BK):
            assert any(first < k0 + DQ_BK and last >= k0
                       for first, last in spans), (q0, k0)


@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_dq_blocks_even_and_encoded(bh, t_q, t_k, causal, window, sms):
    """Any two blocks' key tiles within one item of each other, and the
    flat list giving each block its items in order."""
    blocks = tattn.flash_forward_schedule(bh, t_q, t_k, causal, window, sms,
                                          DQ_BK)
    lengths = [[-(-(hi - lo) // DQ_BK) for _, _, lo, hi in block]
               for block in blocks]
    totals = [sum(block) for block in lengths]
    assert max(totals) - min(totals) <= max(max(b) for b in lengths)
    flat = tattn.flash_work(blocks)
    grid = len(blocks)
    offsets, items = flat[:grid + 1], flat[grid + 1:]
    for b, block in enumerate(blocks):
        assert [tuple(items[4 * i:4 * i + 4])
                for i in range(offsets[b], offsets[b + 1])] == block
    assert all(0 <= x < 2 ** 31 for x in flat)


def test_dq_keeps_the_forward_items():
    """dq deals the forward's items in the forward's order; only the key
    range's alignment follows its own tile."""
    fwd = tattn.flash_forward_schedule(32, 2048, 2048, True, 1024, 132)
    dq = tattn.flash_forward_schedule(32, 2048, 2048, True, 1024, 132, DQ_BK)
    assert [[it[:2] for it in b] for b in fwd] == [[it[:2] for it in b]
                                                   for b in dq]


# ---- dk/dv: (kv head, key tile, query head) items ----------------------

@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_dkv_every_item_exactly_once(bh, t_q, t_k, causal, window, sms,
                                     reps):
    blocks = _dkv(bh, reps, t_q, t_k, causal, window, sms)
    bkv = _kv_heads(bh, reps)
    n_items = bkv * reps * -(-t_k // KV_BK)
    assert len(blocks) == min(n_items, sms) and all(blocks)
    assert sorted(it[:3] for block in blocks for it in block) == sorted(
        (b, k0, r) for b in range(bkv) for k0 in range(0, t_k, KV_BK)
        for r in range(reps))


@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_dkv_row_range_covers_visible_rows_only(bh, t_q, t_k, causal,
                                                window, sms, reps):
    """An item's q tiles start aligned, hold every row that sees a key of
    its tile, and none of them is a tile no row of which sees one."""
    blocks = _dkv(bh, reps, t_q, t_k, causal, window, sms)
    ranges = {it[1]: it[3:] for block in blocks for it in block}
    assert len(ranges) == len({(it[1], *it[3:]) for block in blocks
                               for it in block})
    for k0, (lo, hi) in ranges.items():   # the same for every head
        k_last = min(k0 + KV_BK, t_k) - 1
        rows = [r for r in range(t_q)
                if _sees(r, k0, k_last, t_q, t_k, causal, window)]
        if not rows:
            assert lo == hi == 0
            continue
        assert lo % KV_BQ == 0 and 0 <= lo <= rows[0]
        assert hi == rows[-1] + 1 <= t_q
        for r0 in range(lo, hi, KV_BQ):   # no q tile that no row sees
            assert any(r0 <= r < r0 + KV_BQ for r in rows), (k0, r0)


@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_dkv_blocks_even_within_one_item(bh, t_q, t_k, causal, window, sms,
                                         reps):
    """Longest first, then the snake: any two blocks' q tiles within one
    item of each other, and the list in order of length."""
    blocks = _dkv(bh, reps, t_q, t_k, causal, window, sms)
    totals = [sum(_q_tiles(it) for it in block) for block in blocks]
    longest = max(_q_tiles(it) for block in blocks for it in block)
    assert max(totals) - min(totals) <= longest
    for block in blocks:
        lengths = [_q_tiles(it) for it in block]
        assert lengths == sorted(lengths, reverse=True)


@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_dkv_waits_point_to_earlier_items(bh, t_q, t_k, causal, window, sms,
                                          reps):
    """(a) each block's items lie in increasing list order; (b) item
    (tile, r + 1), which waits for (tile, r), lies after it."""
    blocks = _dkv(bh, reps, t_q, t_k, causal, window, sms)
    flat = tattn.flash_work(blocks)
    grid = len(blocks)
    items = flat[grid + 1:]
    order = [tuple(items[5 * i:5 * i + 5]) for i in range(len(items) // 5)]
    position = {}
    for b, block in enumerate(blocks):
        # the list position of each item, as the snake dealt it
        rounds = [i * grid + (grid - 1 - b if i % 2 else b)
                  for i in range(len(block))]
        assert rounds == sorted(rounds)
        for pos, it in zip(rounds, block):
            position[it[:3]] = pos
    for (bkv, k0, r), pos in position.items():
        if r > 0:
            assert position[(bkv, k0, r - 1)] < pos
    assert len(order) == len(position)


@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_dkv_waits_always_finish(bh, t_q, t_k, causal, window, sms, reps):
    """A run of the kernel's waits with every block resident: each block
    finishes its items in order, item (tile, r) only once (tile, r - 1)
    has finished; in every round some block moves, and all finish."""
    blocks = _dkv(bh, reps, t_q, t_k, causal, window, sms)
    done, at = set(), [0] * len(blocks)
    while any(at[b] < len(block) for b, block in enumerate(blocks)):
        moved = False
        for b, block in enumerate(blocks):
            if at[b] < len(block):
                bkv, k0, r = block[at[b]][:3]
                if r == 0 or (bkv, k0, r - 1) in done:
                    done.add((bkv, k0, r))
                    at[b] += 1
                    moved = True
        assert moved, "the waits deadlock"


@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("bh,t_q,t_k,causal,window,sms", SHAPES)
def test_dkv_work_list_encoding(bh, t_q, t_k, causal, window, sms, reps):
    """The flat list: G + 1 offsets, then five ints an item, block after
    block, as the kernel's ``kv_item`` reads them."""
    blocks = _dkv(bh, reps, t_q, t_k, causal, window, sms)
    flat = tattn.flash_work(blocks)
    grid = len(blocks)
    offsets, items = flat[:grid + 1], flat[grid + 1:]
    assert offsets[0] == 0 and 5 * offsets[-1] == len(items)
    for b, block in enumerate(blocks):
        assert [tuple(items[5 * i:5 * i + 5])
                for i in range(offsets[b], offsets[b + 1])] == block
    assert all(0 <= x < 2 ** 31 for x in flat)


def test_llama_8b_dkv_is_even():
    """At the 8B shape (8 kv heads of 4 query heads, T = 2048, causal) the
    list holds 8 x 16 x 4 = 512 items and 32 x 272 = 8,704 (64-row x
    128-key) steps, 66 a block on average; the longest item has 32, and
    the snake keeps every block within one item of the rest. The kernel
    this replaced gave one block all 4 x 2048 rows of key tile 0."""
    blocks = tattn.flash_backward_schedule(8, 4, 2048, 2048, True, 0, 132)
    items = [it for block in blocks for it in block]
    assert len(items) == 512 and len(blocks) == 132
    per_block = [sum(_q_tiles(it) for it in block) for block in blocks]
    assert sum(per_block) == 8704
    assert max(_q_tiles(it) for it in items) == 32
    assert max(per_block) - min(per_block) <= 32
