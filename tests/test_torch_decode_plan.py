"""K2's launch plan (ops/decode_step.plan_step): how far each product splits
K and how the attention splits the prefix, at the batches and positions the
paths run and at their edges. The plan is plain Python, so it is checked here
on the CPU; the kernel that follows it is checked on the GPU
(tests/test_torch_kernels_gpu.py)."""
import pytest

from tortoise_tpu_torch.ops import decode_step as ds

PRODUCTS = {"qkv": (3, 1), "proj": (1, 1), "fc": (4, 1), "fc2": (1, 4)}  # (N, K) / C


@pytest.mark.parametrize("c", [128, 1024])
@pytest.mark.parametrize("b", [1, 3, 16, 96, 128, 256])
def test_product_splits_cover_k_and_none_is_empty(b, c):
    plan = ds.plan_step(b, c, 100, c // 64)
    for name, (n, k) in PRODUCTS.items():
        steps = k * c // ds.GEMM_DEPTH
        ks, splits = plan[f"ks_{name}"], plan[f"splits_{name}"]
        assert ks >= 1 and splits == -(-steps // ks) <= ds.MAX_SPLITS  # one cluster
        assert (splits - 1) * ks < steps <= splits * ks  # the last split holds a step


@pytest.mark.parametrize("b", [1, 16, 96])
def test_products_fill_the_card_at_full_width(b):
    """At C=1024 every product launches about a wave of blocks or more (the
    16-tile products 16 x 8 = 128), and none more than the target."""
    plan = ds.plan_step(b, 1024, 500, 16)
    for name, (n, _) in PRODUCTS.items():
        tiles = n * 1024 // ds.GEMM_TILE
        blocks = tiles * plan[f"splits_{name}"]
        assert min(ds.SMS, tiles * ds.MAX_SPLITS) <= blocks <= ds.TARGET_BLOCKS, name


@pytest.mark.parametrize("b", [1, 3, 16, 96, 128])
@pytest.mark.parametrize("pos", [0, 1, 31, 32, 33, 63, 64, 65, 255, 500, 566, 767])
def test_attention_splits_cover_the_prefix(b, pos):
    plan = ds.plan_step(b, 1024, pos, 16)
    rows, splits = plan["attn_rows"], plan["attn_splits"]
    if pos == 0:
        assert (rows, splits) == (0, 1)
        return
    assert rows >= min(pos, ds.ATTN_MIN_ROWS) and splits <= ds.MAX_SPLITS
    assert (splits - 1) * rows < pos <= splits * rows  # every split holds a row


@pytest.mark.parametrize("b,pos,splits", [(1, 500, 8), (3, 500, 5), (16, 500, 1),
                                          (96, 566, 1), (1, 64, 2), (1, 63, 1),
                                          (1, 20, 1)])
def test_attention_split_count(b, pos, splits):
    """Up to two blocks an SM, 32 rows a split at least, one cluster of 8 at
    most: 8 splits of 63 rows at B=1, pos=500, one from B=16 on."""
    assert ds.plan_step(b, 1024, pos, 16)["attn_splits"] == splits


@pytest.mark.parametrize("c", [128, 1024])
def test_plan_is_what_the_kernel_accepts(c):
    """The C entry point refuses more than 8 splits or an empty one: the plan
    stays inside that at every batch and position."""
    for b in (1, 2, 16, 96, 128, 256):
        for pos in (0, 1, 64, 500, 767):
            plan = ds.plan_step(b, c, pos, c // 64)
            for name, (_, k) in PRODUCTS.items():
                assert -(-(k * c // ds.GEMM_DEPTH) // plan[f"ks_{name}"]) <= ds.MAX_SPLITS
            if pos:
                assert 1 <= -(-pos // plan["attn_rows"]) <= ds.MAX_SPLITS
