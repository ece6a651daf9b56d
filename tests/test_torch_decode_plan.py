"""K2's persistent schedule (ops/decode_step.plan_step, product_pieces,
attn_split): how each product's tile steps and the attention's prefix go to
the grid's blocks, at the batches and positions the paths run and at their
edges. The schedule is plain Python that the kernel computes the same way,
so it is checked here on the CPU; the kernel that follows it is checked on
the GPU (tests/test_torch_kernels_gpu.py)."""
import pytest

from tortoise_tpu_torch.ops import decode_step as ds

BATCHES = [1, 3, 16, 64, 96, 128, 256]
POSITIONS = [0, 1, 31, 32, 33, 63, 64, 65, 255, 500, 566, 767]


def _check_products(c, blocks):
    """Every product's (tile, K range) pieces cover its N x K exactly once;
    each block's weight bytes lie within one tile step of every other's."""
    for name, (n, k) in ds.PRODUCTS.items():
        steps = k * c // ds.GEMM_DEPTH
        tiles = n * c // ds.GEMM_TILE
        shares = ds.product_pieces(n * c, k * c, blocks)
        assert len(shares) == blocks
        covered = {}
        for pieces in shares:
            for t, k0, k1 in pieces:
                assert 0 <= t < tiles and 0 <= k0 < k1 <= steps, (name, t, k0, k1)
                for s in range(k0, k1):
                    assert (t, s) not in covered, (name, t, s)
                    covered[t, s] = True
        assert len(covered) == tiles * steps, name
        held = [sum(k1 - k0 for _, k0, k1 in pieces) for pieces in shares]
        used = held[:min(blocks, tiles * steps)]
        assert max(used) - min(used) <= 1, name  # one 64 x 64 tile step: 8 KB bf16
        assert all(h == 0 for h in held[len(used):]), name
        # a block's pieces lie in contiguous tiles: at most max_pieces of them
        assert max(len(p) for p in shares) <= ds.max_pieces(c, blocks), name


def _check_grid(plan):
    """The grid is the SMs times the blocks the kernel's shared memory and
    threads fit on one SM."""
    per_sm = ds.blocks_per_sm()
    assert per_sm >= 1 and plan["blocks"] == ds.SMS * per_sm
    assert per_sm * (ds.BLOCK_SMEM + ds.SM_SMEM_RESERVED) <= ds.SM_SMEM
    assert per_sm * ds.BLOCK_THREADS <= ds.SM_THREADS


def _check_attention(plan, b, heads, pos):
    """The launches cover the batch, each at most MAX_ROWS rows; each
    launch's attention splits cover [0, pos) with no empty split, and its
    items fit the grid where the prefix is split at all."""
    rows = [launch["rows"] for launch in plan["launches"]]
    assert sum(rows) == b and all(1 <= r <= ds.MAX_ROWS for r in rows)
    assert [launch["row0"] for launch in plan["launches"]] == \
        [sum(rows[:i]) for i in range(len(rows))]
    for launch in plan["launches"]:
        per, splits = launch["attn_rows"], launch["attn_splits"]
        if pos == 0:
            assert (per, splits) == (0, 1)
            continue
        assert per >= ds.ATTN_MIN_ROWS and per % ds.ATTN_MIN_ROWS == 0
        assert (splits - 1) * per < pos <= splits * per  # every split holds a row
        if splits > 1:
            assert launch["rows"] * heads * splits <= plan["blocks"]


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("c", [128, 1024])
@pytest.mark.parametrize("b", BATCHES)
def test_schedule_covers_the_step(b, c, pos):
    heads = c // ds.HEAD_DIM
    plan = ds.plan_step(b, c, pos, heads)
    _check_grid(plan)
    _check_products(c, plan["blocks"])
    _check_attention(plan, b, heads, pos)


@pytest.mark.parametrize("b,pos,splits", [(1, 500, 8), (3, 500, 2), (16, 500, 1),
                                          (96, 566, 1), (1, 64, 2), (1, 33, 2),
                                          (1, 20, 1)])
def test_attention_split_count(b, pos, splits):
    """At B=1 and pos=500 8 splits of 64 rows keep 128 of 132 blocks busy;
    from B=16 the items fill the grid unsplit."""
    assert ds.plan_step(b, 1024, pos, 16)["launches"][0]["attn_splits"] == splits


def test_full_width_products_split_k_over_at_most_two_tiles_a_block():
    """At C=1024 on 132 blocks a block's share of any product is 2 to 8 K
    steps, so it touches at most two tiles (the workspace's pieces)."""
    assert ds.max_pieces(1024, ds.SMS) == 2
    for n, k in ds.PRODUCTS.values():
        held = [sum(k1 - k0 for _, k0, k1 in p)
                for p in ds.product_pieces(n * 1024, k * 1024, ds.SMS)]
        assert 1 <= min(held) and max(held) <= 8
