"""The operation and byte counters against counts made by hand."""

from h100bench import work

TINY = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2, "head_dim": 2, "d_ff": 16,
        "vocab_size": 10}


def test_keys_seen():
    assert work.keys_seen(TINY, 0, 4) == 1 + 2 + 3 + 4
    assert work.keys_seen(dict(TINY, sliding_window=2), 0, 4) == 1 + 2 + 2 + 2
    assert work.keys_seen(TINY, 2, 4) == 3 + 4


def test_dense_token_and_prefill():
    # q: 8x8, k and v: 8x4 each, o: 8x8 -> 192 MACs; MLP 3 x 8 x 16 = 384 MACs
    assert work.token_weight_flops(TINY) == 2 * (192 + 384)
    # a prefill of 3 tokens: per layer 3 tokens' weights, 1+2+3 (query, key) pairs at 4 heads x 2 dims x 4
    per_layer = 3 * 2 * 576 + 4 * 4 * 2 * 6
    assert work.prefill_flops(TINY, 0, 3) == 2 * per_layer + 2 * 8 * 10
    # one decode row with 5 tokens (the new one included)
    assert work.decode_flops(TINY, [5]) == 2 * (2 * 576 + 4 * 4 * 2 * 5) + 2 * 8 * 10


def test_moe_counts_top_k_and_router():
    moe = dict(TINY, n_experts=4, top_k=2)
    # router 8x4 = 32 MACs, two experts of 3 x 8 x 16 MACs
    assert work.token_weight_flops(moe) == 2 * 192 + 2 * 32 + 2 * 6 * 8 * 16


def test_paged_and_flash_bytes():
    # a row of 3 visible tokens: K and V rows of 2 heads x 2 dims, q and o of 4 heads x 2 dims, bf16
    assert work.paged_bytes(TINY, [3]) == 3 * 2 * 2 * 2 * 2 + 2 * 4 * 2 * 2
    assert work.paged_bytes(dict(TINY, sliding_window=2), [3, 1]) == (2 + 1) * 16 + 2 * 32
    flops, nbytes = work.flash_work(TINY, 0, 3)
    assert flops == 4 * 4 * 2 * 6
    assert nbytes == (3 * 2 * 4 + 3 * 2 * 2) * 2 * 2
