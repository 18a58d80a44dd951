"""Port kernels vs the JAX package: the plain PyTorch versions of the paged
decode and flash prefill kernels against the Pallas kernels run in interpret
mode, and the page-layout ops against ``repro.kernels.ops``. Inputs are made
with numpy from a seed and handed to both packages.

Tolerances are those of tests/test_kernels.py: flash 2e-5 (f32) / 2e-2
(bf16), paged 3e-5 / 3e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.paged_attention import paged_attention_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain  # noqa: E402

TOL = {"flash": {"float32": 2e-5, "bfloat16": 2e-2}, "paged": {"float32": 3e-5, "bfloat16": 3e-2}}
NEG_INF = -1e30


def both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounding of
    the f32 numpy input is round-to-nearest-even in both)."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


# ------------------------------ paged attention ------------------------------
# (B, S, T, H, K, D, window, dtype): tests/test_kernels.py PAGED_CASES, plus
# the default page size of llama3.2-1b (T=64, D=64)
PAGED_CASES = [
    (2, 64, 8, 4, 4, 64, None, "float32"),
    (3, 128, 16, 8, 2, 64, None, "float32"),
    (2, 64, 8, 4, 1, 128, None, "bfloat16"),
    (2, 128, 16, 4, 4, 32, 48, "float32"),
    (1, 256, 32, 2, 2, 64, 100, "bfloat16"),
    (3, 192, 64, 32, 8, 64, None, "bfloat16"),
]


def paged_inputs(seed, B, S, T, H, K, D, dtype, extra_pages=2):
    """Random pool with every sequence's pages scattered through it in a
    random order (one headroom page per sequence), random lengths <= S."""
    rng = np.random.default_rng(seed)
    R = S // T + 1
    P = B * R + extra_pages
    pool_k = rng.standard_normal((P, T, K, D), dtype=np.float32)
    pool_v = rng.standard_normal((P, T, K, D), dtype=np.float32)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    tables = rng.permutation(P)[: B * R].reshape(B, R).astype(np.int32)
    page_pos = np.repeat((np.arange(R, dtype=np.int32) * T)[None], B, axis=0)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    lengths[0] = S
    return q, pool_k, pool_v, tables, page_pos, lengths


def run_paged(q, pool_k, pool_v, tables, page_pos, lengths, dtype, window):
    jq, tq = both(q, dtype)
    jk, tk = both(pool_k, dtype)
    jv, tv = both(pool_v, dtype)
    want = paged_attention_pallas(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(page_pos), jnp.asarray(lengths),
        window=window, interpret=True,
    )
    got = paged_attention_plain(
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(page_pos),
        torch.from_numpy(lengths), window=window,
    )
    return got, want


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_pallas(case):
    B, S, T, H, K, D, window, dtype = case
    inputs = paged_inputs(3, B, S, T, H, K, D, dtype)
    got, want = run_paged(*inputs, dtype, window)
    tol = TOL["paged"][dtype]
    for g, w in zip(got, want):  # o, m, l themselves, unnormalised
        close(g, w, tol)


def test_paged_plain_ring_page_pos_matches_pallas():
    """A sliding-window ring: the first page was recycled and now holds the
    newest positions, so page_pos is not increasing along the table."""
    B, T, H, K, D, window = 2, 4, 4, 2, 32, 8
    R = window // T + 1
    rng = np.random.default_rng(11)
    P = B * R
    pool_k = rng.standard_normal((P, T, K, D), dtype=np.float32)
    pool_v = rng.standard_normal((P, T, K, D), dtype=np.float32)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    tables = np.arange(P, dtype=np.int32).reshape(B, R)
    page_pos = np.array([[12, 4, 8], [12, 16, 8]], np.int32)
    lengths = np.array([14, 19], np.int32)
    got, want = run_paged(q, pool_k, pool_v, tables, page_pos, lengths, "float32", window)
    for g, w in zip(got, want):
        close(g, w, TOL["paged"]["float32"])


def test_paged_plain_sentinel_row_is_zero_not_nan():
    """The engine's inactive rows: every table entry is the out-of-range
    sentinel P and the length is 0. They must give o=0, l=0, m=-1e30."""
    B, S, T, H, K, D = 3, 64, 16, 4, 2, 32
    q, pool_k, pool_v, tables, page_pos, lengths = paged_inputs(5, B, S, T, H, K, D, "float32")
    P = pool_k.shape[0]
    tables[1] = P
    lengths[1] = 0
    got, want = run_paged(q, pool_k, pool_v, tables, page_pos, lengths, "float32", None)
    o, m, l = (as_np(t) for t in got)
    assert np.isfinite(o).all() and np.isfinite(m).all() and np.isfinite(l).all()
    np.testing.assert_array_equal(o[1], 0.0)
    np.testing.assert_array_equal(l[1], 0.0)
    np.testing.assert_array_equal(m[1], np.float32(NEG_INF))
    for g, w in zip(got, want):
        close(g, w, TOL["paged"]["float32"])
    out = ops.paged_attention(
        torch.from_numpy(q), torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        torch.from_numpy(tables), torch.from_numpy(page_pos), torch.from_numpy(lengths),
    )
    assert torch.isfinite(out).all() and (out[1] == 0).all()


@pytest.mark.parametrize("impl", [None, "ref"])
@pytest.mark.parametrize("case", [PAGED_CASES[1], PAGED_CASES[4]])
def test_paged_attention_op_matches_jax_ref(case, impl):
    B, S, T, H, K, D, window, dtype = case
    q, pool_k, pool_v, tables, page_pos, lengths = paged_inputs(7, B, S, T, H, K, D, dtype)
    jq, tq = both(q, dtype)
    jk, tk = both(pool_k, dtype)
    jv, tv = both(pool_v, dtype)
    want = jref.paged_attention_ref(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(page_pos), jnp.asarray(lengths), window=window
    )
    got = ops.paged_attention(
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(page_pos),
        torch.from_numpy(lengths), window=window, impl=impl,
    )
    assert got.dtype == tq.dtype
    close(got, want, TOL["paged"][dtype])


def test_online_softmax_combine_matches_jax():
    rng = np.random.default_rng(2)
    o = rng.standard_normal((3, 2, 4, 8), dtype=np.float32)
    m = rng.standard_normal((3, 2, 4), dtype=np.float32)
    l = rng.uniform(0.5, 2.0, (3, 2, 4)).astype(np.float32)
    want = jref.online_softmax_combine(jnp.asarray(o), jnp.asarray(m), jnp.asarray(l))
    got = ref.online_softmax_combine(torch.from_numpy(o), torch.from_numpy(m), torch.from_numpy(l))
    close(got, want, 1e-6)


# ------------------------- split-K (flash-decoding) -------------------------
def split_case(name, D=32):
    """Inputs for the split-K contract: (q, pool_k, pool_v, tables, page_pos,
    lengths, window, page_offset, n_sm). ``n_sm`` is picked so that the
    launch plan gives S = 4 (3 for the ring)."""
    rng = np.random.default_rng(21)
    T, H, K = 8, 8, 2
    if name == "serving":  # engine layout: own pages then sentinels; an inactive row
        B, R, P, off = 4, 6, 20, 0
        lengths = np.array([33, 0, 12, 47], np.int32)
        tables = np.full((B, R), P, np.int32)
        perm, used = rng.permutation(P), 0
        for b, n in enumerate(lengths):
            k = 0 if n == 0 else n // T + 1
            tables[b, :k] = perm[used:used + k]
            used += k
        page_pos = np.repeat((np.arange(R, dtype=np.int32) * T)[None], B, axis=0)
        window, n_sm = None, 16
    elif name == "ring":  # a sliding-window ring: page_pos not increasing
        B, R, P, off, T = 2, 3, 6, 0, 4
        tables = np.arange(P, dtype=np.int32).reshape(B, R)
        page_pos = np.array([[12, 4, 8], [12, 16, 8]], np.int32)
        lengths = np.array([14, 19], np.int32)
        window, n_sm = 8, 12
    elif name == "window":  # 2 of 8 pages in the window: two of four shares empty
        B, R, P, off = 2, 8, 16, 0
        tables = rng.permutation(P)[: B * R].reshape(B, R).astype(np.int32)
        page_pos = np.repeat((np.arange(R, dtype=np.int32) * T)[None], B, axis=0)
        lengths = np.array([60, 9], np.int32)
        window, n_sm = 10, 8
    elif name == "offset":  # a pool shard: ids outside [offset, offset + P) are skipped
        B, R, P, off = 3, 5, 12, 7
        tables = (rng.permutation(2 * P)[: B * R].reshape(B, R) + 1).astype(np.int32)
        page_pos = np.repeat((np.arange(R, dtype=np.int32) * T)[None], B, axis=0)
        lengths = np.array([40, 3, 25], np.int32)
        window, n_sm = None, 12
    pool_k = rng.standard_normal((P, T, K, D), dtype=np.float32)
    pool_v = rng.standard_normal((P, T, K, D), dtype=np.float32)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    return q, pool_k, pool_v, tables, page_pos, lengths, window, off, n_sm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["serving", "ring", "window", "offset"])
def test_paged_split_shares_merge_to_pallas(name, dtype):
    """The kernel's split-K contract on the CPU: cut each row's valid pages
    into the shares the kernel's CTAs take, run the plain version on each
    share, merge with the kernel's merge, and hold the result (o, m, l
    unnormalised) against the Pallas kernel in interpret mode."""
    q, pool_k, pool_v, tables, page_pos, lengths, window, off, n_sm = split_case(name)
    B, H, D = q.shape
    P, T, K, _ = pool_k.shape
    plan = tpa.launch_plan(B, H, K, D, tables.shape[1], n_sm)
    assert plan.n_splits == (3 if name == "ring" else 4)
    jq, tq = both(q, dtype)
    jk, tk = both(pool_k, dtype)
    jv, tv = both(pool_v, dtype)
    tt, tp, tl = (torch.from_numpy(a) for a in (tables, page_pos, lengths))
    per_split = tpa.split_tables(tt, tp, tl, T=T, P=P, n_splits=plan.n_splits, window=window,
                                 page_offset=off)
    parts = [paged_attention_plain(tq, tk, tv, t, tp, tl, window=window, page_offset=off)
             for t in per_split]
    o, m, l = tpa.merge_partials(*(torch.stack(x) for x in zip(*parts)))
    want = paged_attention_pallas(jq, jk, jv, jnp.asarray(tables), jnp.asarray(page_pos),
                                  jnp.asarray(lengths), window=window, page_offset=off,
                                  interpret=True)
    for g, w in zip((o, m, l), want):
        close(g, w, TOL["paged"][dtype])
    # every valid page is in exactly one share; no share holds an invalid one
    for b in range(B):
        valid = tpa.valid_pages(tables[b], page_pos[b], int(lengths[b]), T=T, P=P, window=window,
                                page_offset=off)
        taken = sorted(r for t in per_split for r in np.flatnonzero(t[b].numpy() != off + P))
        assert taken == valid
    dead = lengths == 0
    if dead.any():  # the all-sentinel row: o=0, l=0, m=-1e30 after the merge
        assert (o[dead] == 0).all() and (l[dead] == 0).all() and (m[dead] == NEG_INF).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [80, 120])
def test_paged_split_shares_merge_to_pallas_wide_rows(D, dtype):
    """The split-K contract at the head dims that are not a power of two
    (zamba2's 80, h2o-danube's 120): the partials are (S, B, H, D) at the
    real D, merged as at any other width."""
    q, pool_k, pool_v, tables, page_pos, lengths, window, off, n_sm = split_case("serving", D)
    B, H, _ = q.shape
    P, T, K, _ = pool_k.shape
    plan = tpa.launch_plan(B, H, K, D, tables.shape[1], n_sm)
    assert plan.n_splits == 4 and plan.scratch_bytes == 4 * B * H * (D + 2) * 4
    jq, tq = both(q, dtype)
    jk, tk = both(pool_k, dtype)
    jv, tv = both(pool_v, dtype)
    tt, tp, tl = (torch.from_numpy(a) for a in (tables, page_pos, lengths))
    per_split = tpa.split_tables(tt, tp, tl, T=T, P=P, n_splits=plan.n_splits, window=window)
    parts = [paged_attention_plain(tq, tk, tv, t, tp, tl, window=window) for t in per_split]
    o, m, l = tpa.merge_partials(*(torch.stack(x) for x in zip(*parts)))
    want = paged_attention_pallas(jq, jk, jv, jnp.asarray(tables), jnp.asarray(page_pos),
                                  jnp.asarray(lengths), window=window, interpret=True)
    for g, w in zip((o, m, l), want):
        close(g, w, TOL["paged"][dtype])


# (B, S, T, H, K, D, window, dtype): h2o-danube-3-4b's head dim 120 (32
# heads over 8 kv-heads) and zamba2-2.7b's 80 (as many kv-heads as heads)
WIDE_PAGED_CASES = [
    (2, 128, 16, 8, 2, 120, None, "bfloat16"),
    (2, 128, 16, 8, 2, 120, 40, "float32"),
    (2, 128, 16, 4, 4, 80, None, "float32"),
    (2, 128, 16, 4, 4, 80, 40, "bfloat16"),
]


@pytest.mark.parametrize("case", WIDE_PAGED_CASES)
def test_paged_plain_matches_pallas_wide_heads(case):
    B, S, T, H, K, D, window, dtype = case
    got, want = run_paged(*paged_inputs(8, B, S, T, H, K, D, dtype), dtype, window)
    for g, w in zip(got, want):
        close(g, w, TOL["paged"][dtype])


def test_head_dims_the_kernels_take():
    """Both kernels take every head dim that is a multiple of 8 up to 128:
    the paged kernel pads a row to the next power-of-two count of 16-byte
    lanes (a width of 16, 32, 64 or 128), the bf16 flash kernel to the next
    of 16, 32, 64, 128; any other head dim raises ValueError."""
    from repro_torch.kernels import flash_attention as tfa

    bf16, f32 = 2, 4
    assert [tpa.padded_width(D, bf16) for D in (8, 16, 24, 64, 80, 120, 128)] == [16, 16, 32, 64, 128, 128, 128]
    assert [tpa.padded_width(D, f32) for D in (8, 16, 24, 64, 80, 120, 128)] == [16, 16, 32, 64, 128, 128, 128]
    assert [tfa.tc_width(D) for D in (8, 16, 40, 64, 80, 120, 128)] == [16, 16, 64, 64, 128, 128, 128]
    # shared memory: table ids + positions, and 4 warps' partials at the padded width
    plan = tpa.launch_plan(8, 32, 8, 120, 72, 132)
    assert tpa.smem_bytes(72, plan.head_chunk, 128) == 8 * 72 + 16 * plan.head_chunk * 130
    assert tfa.launch_plan(1, 128, 32, 8, 120, torch.bfloat16).smem_bytes == 2 * 136 * (4 * 16 + 6 * 64)
    f32 = tfa.launch_plan(1, 128, 32, 8, 120, torch.float32)
    assert f32.smem_bytes == 4 * (2 * 16 * 120 + 64 * 121 + 64 * 120 + 16 * 64 + 48)
    for D in (8, 80, 120, 128):
        tpa.check_head_dim(D, "x")
    for D in (0, 4, 100, 121, 136):
        with pytest.raises(ValueError, match="multiple of 8"):
            tpa.check_head_dim(D, "x")


@pytest.mark.parametrize("n_valid,n_splits", [(4, 5), (13, 5), (0, 3), (2, 4), (7, 1)])
def test_paged_page_shares_cover_each_valid_page_once(n_valid, n_splits):
    """Shares are contiguous, in order, cover [0, n) exactly, and differ in
    size by at most one page (rows with fewer pages than splits leave some
    shares empty)."""
    shares = tpa.page_shares(n_valid, n_splits)
    assert len(shares) == n_splits and shares[0][0] == 0 and shares[-1][1] == n_valid
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [e - s for s, e in shares]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


def test_paged_launch_plan_is_static():
    """The grid and scratch come from static shapes only (never lengths,
    which would need a host sync): at the serving shape (8 slots, 8 kv-heads
    of 4 query heads, 32 table entries, 132 SMs) the grid is the largest
    that runs in one wave of two CTAs per SM, and lengths are not even an
    input of the plan."""
    import inspect

    assert "lengths" not in inspect.signature(tpa.launch_plan).parameters
    plan = tpa.launch_plan(8, 32, 8, 64, 32, 132)
    S, ys, B = plan.grid
    assert (plan.n_splits, plan.head_chunk) == (4, 4)
    assert S * ys * B <= 2 * 132 < (S + 1) * ys * B
    assert plan.scratch_bytes == 4 * 8 * 32 * 66 * 4
    # one table entry per split at most; more heads per kv-head go in chunks of 8
    assert tpa.launch_plan(1, 1, 1, 64, 3, 132).n_splits == 3
    assert tpa.launch_plan(64, 32, 8, 64, 32, 132).n_splits == 1  # more rows than a wave
    assert tpa.launch_plan(2, 64, 4, 128, 64, 132).head_chunk == 8
    assert tpa.launch_plan(2, 96, 8, 128, 64, 132).head_chunk == 4
    # the serving engine's shape at any lengths gives the same plan
    assert tpa.launch_plan(8, 32, 8, 64, 32, 132) == plan


def test_flash_launch_plan_packs_the_heads_of_a_kv_head():
    """bf16 packs up to 4 query heads of one kv-head into a CTA, a warp each
    (llama3.2-1b prefill: 96 CTAs of 4 heads); f32 keeps one CTA per (16
    rows, head)."""
    from repro_torch.kernels.flash_attention import launch_plan

    bf = launch_plan(1, 192, 32, 8, 64, torch.bfloat16)
    assert bf.heads_per_cta == 4 and bf.grid == (12, 8, 1) and bf.threads == 128
    assert launch_plan(2, 100, 4, 2, 16, torch.bfloat16).heads_per_cta == 2
    assert launch_plan(1, 16, 8, 8, 64, torch.bfloat16).heads_per_cta == 1
    f32 = launch_plan(1, 192, 32, 8, 64, torch.float32)
    assert f32.grid == (12, 32, 1) and f32.threads == 128


def test_refused_inputs_raise():
    """An int8 pool without its scales is refused, and so is a sharded call
    (``axis_names``) without the mesh that names its axes."""
    x = torch.zeros((1, 1, 1, 4))
    pool = torch.zeros((1, 1, 1, 4), dtype=torch.int8)
    t = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="scale"):
        ops.paged_attention(x[0], pool, pool, t, t, t[0])
    with pytest.raises(ValueError, match="scale"):
        ops.paged_update(pool, pool, t, t, t[0], x[0], x[0])
    with pytest.raises(ValueError, match="mesh"):
        ops.paged_attention(x[0], x, x, t, t, t[0] + 1, axis_names=("model",))


@pytest.mark.parametrize("impl", [None, "ref"])
def test_sharded_call_on_one_rank_is_the_unsharded_call(impl):
    """The split-K combine over axes of one rank sends nothing and changes
    nothing: the kernel path (plain on the CPU) and ``impl="ref"`` (the
    plain partials, never the unsharded oracle, as the JAX rule) equal the
    unsharded kernel path. Across ranks: tests/test_torch_parallel.py."""
    from repro_torch.parallel import collectives
    from repro_torch.parallel.axisinfo import Mesh

    B, S, T, H, K, D = 3, 128, 16, 8, 2, 64
    arrays = paged_inputs(8, B, S, T, H, K, D, "float32")
    arrays[-1][1] = 0  # a row with no token: o stays 0
    q, pool_k, pool_v, tables, page_pos, lengths = (torch.from_numpy(a) for a in arrays)
    mesh = Mesh((1, 1), ("data", "model"))
    calls = collectives.stats["calls"]
    got = ops.paged_attention(q, pool_k, pool_v, tables, page_pos, lengths, axis_names=("data", "model"),
                              mesh=mesh, impl=impl)
    want = ops.paged_attention(q, pool_k, pool_v, tables, page_pos, lengths)
    assert collectives.stats["calls"] == calls
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got[1].abs().max()) == 0.0


# ------------------------------ int8 KV ------------------------------
def int8_tokens(seed, shape):
    """Random tokens (..., K, D) plus, in the first two, exact .5 ties (a
    token whose largest |value| is 127 has scale exactly 1) and an
    all-zero token (the 1e-8 floor)."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * 3
    D = shape[-1]
    tie = np.resize(np.array([0.5, -0.5, 1.5, -2.5, 3.5, 126.5], np.float32), D)
    tie[0] = 127.0
    x.reshape(-1, D)[0] = tie
    x.reshape(-1, D)[1] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_token_bit_equal_to_jax(dtype):
    jx, tx = both(int8_tokens(31, (6, 8, 2, 32)), dtype)
    want_q, want_s = jops.quantize_token(jx)
    got_q, got_s = ops.quantize_token(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32), np.asarray(want_s).view(np.int32))
    flat_q, flat_s = got_q.reshape(-1, 32), got_s.reshape(-1)
    assert flat_s[0] == 1.0 and flat_q[0, :6].tolist() == [127, 0, 2, -2, 4, 126]  # half to even
    assert flat_s[1] == np.float32(1e-8) / np.float32(127.0) and not flat_q[1].any()


def test_dequantize_pool_bit_equal_to_jax():
    x = int8_tokens(32, (6, 8, 2, 32))
    jq, js = jops.quantize_token(jnp.asarray(x))
    want = jops.dequantize_pool(jq, js)
    got = ops.dequantize_pool(torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


def test_int8_paged_update_matches_jax():
    """14 appends wrap each row's 3-page ring (window 8, T 4); row 2's pages
    are not local to the pool (dropped). Pools, scales and page_pos
    bit-equal to JAX's after every step."""
    B, T, K, D, R = 3, 4, 2, 16, 3
    rng = np.random.default_rng(33)
    q0, s0 = jops.quantize_token(jnp.asarray(rng.standard_normal((2 * R, T, K, D), dtype=np.float32)))
    jst = [q0, q0, s0, s0]
    tst = [torch.from_numpy(np.array(a)) for a in jst]
    tables = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)  # row 2: ids >= P = 6
    jpp = jnp.asarray(np.repeat((np.arange(R, dtype=np.int32) * T)[None], B, axis=0))
    tpp = torch.from_numpy(np.array(jpp))
    for t in range(14):
        nk = rng.standard_normal((B, K, D), dtype=np.float32)
        nv = rng.standard_normal((B, K, D), dtype=np.float32)
        length = np.array([t, t + 3, t], np.int32)
        jk, jv, jpp, jsk, jsv = jops.paged_update(
            jst[0], jst[1], jnp.asarray(tables), jpp, jnp.asarray(length), jnp.asarray(nk), jnp.asarray(nv),
            scale_k=jst[2], scale_v=jst[3])
        jst = [jk, jv, jsk, jsv]
        tk, tv, tpp, tsk, tsv = ops.paged_update(
            tst[0], tst[1], torch.from_numpy(tables), tpp, torch.from_numpy(length), torch.from_numpy(nk),
            torch.from_numpy(nv), scale_k=tst[2], scale_v=tst[3])
        assert tk is tst[0] and tsk is tst[2]  # in place
        np.testing.assert_array_equal(tpp.numpy(), np.asarray(jpp))
        for got, want in zip((tk, tv, tsk, tsv), jst):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", [None, "ref"])
def test_paged_attention_int8_matches_jax(impl):
    """tests/test_kernels.py's int8 cases on the port: a quantized pool is
    dequantized to bf16 and read by the kernel's plain version (CPU) or the
    oracle; held to JAX's wrapper on the same pool (its Pallas kernel in
    interpret mode, or its oracle) within the paged tolerance, and within 2%
    of the f32 pool's attention. A token written through the int8
    paged_update reads back within 1%."""
    B, S, T, H, K, D = 2, 128, 16, 8, 2, 64
    rng = np.random.default_rng(34)
    k = rng.standard_normal((B, S, K, D), dtype=np.float32)
    v = rng.standard_normal((B, S, K, D), dtype=np.float32)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    pool_k, pool_v, tables, page_pos = ops.prefill_into_pages(torch.from_numpy(k), torch.from_numpy(v), T)
    lengths = torch.full((B,), S - 5, dtype=torch.int32)
    fp = ref.paged_attention_ref(torch.from_numpy(q), pool_k, pool_v, tables, page_pos, lengths)
    (qk, sk), (qv, sv) = ops.quantize_token(pool_k), ops.quantize_token(pool_v)
    got = ops.paged_attention(torch.from_numpy(q), qk, qv, tables, page_pos, lengths,
                              scale_k=sk, scale_v=sv, impl=impl)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    want = jops.paged_attention(jnp.asarray(q), j(qk), j(qv), j(tables), j(page_pos), j(lengths),
                                scale_k=j(sk), scale_v=j(sv), impl="pallas" if impl is None else "ref",
                                interpret=True)
    close(got, want, TOL["paged"]["float32"])
    assert (got - fp).abs().max() / fp.abs().max() < 0.02

    nk = torch.from_numpy(rng.standard_normal((B, K, D), dtype=np.float32))
    ops.paged_update(qk, qv, tables, page_pos, lengths, nk, nk, scale_k=sk, scale_v=sv)
    back = ops.dequantize_pool(qk, sk)[tables[:, (S - 5) // T], (S - 5) % T].float()
    torch.testing.assert_close(back, nk, atol=nk.abs().max().item() / 100, rtol=0)


# ------------------------------ flash attention ------------------------------
# (B, Sq, Sk, H, K, D, causal, window, dtype): tests/test_kernels.py FLASH_CASES
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64, True, None, "float32"),
    (2, 256, 256, 4, 2, 64, True, None, "float32"),
    (1, 128, 128, 8, 1, 128, True, None, "bfloat16"),
    (2, 128, 128, 4, 4, 32, False, None, "float32"),
    (1, 256, 256, 2, 2, 64, True, 64, "float32"),
    (1, 512, 512, 2, 1, 64, True, 128, "bfloat16"),
    (2, 128, 256, 4, 4, 64, False, None, "float32"),
]


def flash_inputs(seed, B, Sq, Sk, H, K, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, K, D), dtype=np.float32),
            rng.standard_normal((B, Sk, K, D), dtype=np.float32))


# head dims 120 and 80 (h2o-danube-3-4b, zamba2-2.7b), causal and windowed
WIDE_FLASH_CASES = [
    (1, 128, 128, 8, 2, 120, True, None, "bfloat16"),
    (1, 128, 128, 8, 2, 120, True, 48, "float32"),
    (2, 128, 128, 4, 4, 80, True, None, "float32"),
    (1, 128, 128, 4, 4, 80, True, 48, "bfloat16"),
]


@pytest.mark.parametrize("case", FLASH_CASES + WIDE_FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    B, Sq, Sk, H, K, D, causal, window, dtype = case
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in flash_inputs(42, B, Sq, Sk, H, K, D))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  block_q=64, block_k=64, interpret=True)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    close(got, want, TOL["flash"][dtype])


# The Pallas wrapper asserts Sq % block_q == 0, so these are held against
# repro.kernels.ref.attention_ref: a ragged 192-token prompt (3 pages of 64),
# and a q_start offset (a chunk of queries after 128 cached keys).
RAGGED_CASES = [
    (1, 192, 192, 32, 8, 64, True, None, 0, "bfloat16"),
    (1, 192, 192, 4, 2, 64, True, None, 0, "float32"),
    (2, 100, 100, 4, 2, 16, True, 48, 0, "float32"),
    (1, 64, 192, 4, 1, 32, True, None, 128, "float32"),
]


@pytest.mark.parametrize("impl", [None, "ref"])
@pytest.mark.parametrize("case", RAGGED_CASES)
def test_flash_op_ragged_matches_jax_ref(case, impl):
    B, Sq, Sk, H, K, D, causal, window, q_start, dtype = case
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in flash_inputs(9, B, Sq, Sk, H, K, D))
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window, q_start=q_start)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window, q_start=q_start, impl=impl)
    close(got, want, TOL["flash"][dtype])


def test_wrappers_take_plain_version_on_cpu_without_counting():
    q, k, v = (torch.from_numpy(x) for x in flash_inputs(1, 1, 32, 32, 4, 2, 16))
    n_flash, n_paged = flash_attention_cuda.launches, paged_attention_cuda.launches
    torch.testing.assert_close(flash_attention_cuda(q, k, v), flash_attention_plain(q, k, v))
    inputs = [torch.from_numpy(x) for x in paged_inputs(1, 2, 32, 8, 4, 2, 16, "float32")]
    for g, w in zip(paged_attention_cuda(*inputs), paged_attention_plain(*inputs)):
        torch.testing.assert_close(g, w)
    assert (flash_attention_cuda.launches, paged_attention_cuda.launches) == (n_flash, n_paged)


# ------------------------------ page-layout ops ------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page_offset", [0, 4])
def test_paged_update_matches_jax(dtype, page_offset):
    """One appended token per row, incl. a row whose page is the sentinel
    (dropped) and, with an offset, rows whose pages are not local."""
    B, T, K, D, R, P = 4, 8, 2, 16, 3, 12
    rng = np.random.default_rng(4)
    pool_k = rng.standard_normal((P, T, K, D), dtype=np.float32)
    pool_v = rng.standard_normal((P, T, K, D), dtype=np.float32)
    tables = rng.permutation(P)[: B * R].reshape(B, R).astype(np.int32)
    tables[2] = P + page_offset  # sentinel: not in [0, P) after the offset
    page_pos = np.repeat((np.arange(R, dtype=np.int32) * T)[None], B, axis=0)
    lengths = np.array([0, 9, 5, 16], np.int32)
    new_k = rng.standard_normal((B, K, D), dtype=np.float32)
    new_v = rng.standard_normal((B, K, D), dtype=np.float32)
    jk, tk = both(pool_k, dtype)
    jv, tv = both(pool_v, dtype)
    want = jops.paged_update(jk, jv, jnp.asarray(tables), jnp.asarray(page_pos),
                             jnp.asarray(lengths), jnp.asarray(new_k), jnp.asarray(new_v),
                             page_offset=page_offset)
    got = ops.paged_update(tk, tv, torch.from_numpy(tables), torch.from_numpy(page_pos),
                           torch.from_numpy(lengths), torch.from_numpy(new_k),
                           torch.from_numpy(new_v), page_offset=page_offset)
    assert got[0] is tk and got[1] is tv  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(as_np(g), as_np(w))


def test_paged_update_ring_rollover_matches_jax():
    """SWA ring: 14 appends wrap a 3-page ring; pools and page_pos agree
    with the JAX version after every step."""
    B, T, K, D = 1, 4, 2, 8
    R = 8 // T + 1
    rng = np.random.default_rng(12)
    jk = jv = jnp.zeros((B * R, T, K, D), jnp.float32)
    tk, tv = torch.zeros((B * R, T, K, D)), torch.zeros((B * R, T, K, D))
    tables = np.arange(B * R, dtype=np.int32).reshape(B, R)
    jpp = jnp.asarray((np.arange(R, dtype=np.int32) * T)[None])
    tpp = torch.from_numpy(np.array(jpp))
    for t in range(14):
        nk = rng.standard_normal((B, K, D), dtype=np.float32)
        nv = rng.standard_normal((B, K, D), dtype=np.float32)
        length = np.full((B,), t, np.int32)
        jk, jv, jpp = jops.paged_update(jk, jv, jnp.asarray(tables), jpp, jnp.asarray(length),
                                        jnp.asarray(nk), jnp.asarray(nv))
        tk, tv, tpp = ops.paged_update(tk, tv, torch.from_numpy(tables), tpp, torch.from_numpy(length),
                                       torch.from_numpy(nk), torch.from_numpy(nv))
        np.testing.assert_array_equal(tpp.numpy(), np.asarray(jpp))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("extra_pages,pad_pages_to", [(1, 1), (0, 1), (2, 4)])
def test_prefill_into_pages_matches_jax(extra_pages, pad_pages_to):
    B, S, T, K, D = 2, 32, 8, 2, 16
    rng = np.random.default_rng(6)
    k = rng.standard_normal((B, S, K, D), dtype=np.float32)
    v = rng.standard_normal((B, S, K, D), dtype=np.float32)
    want = jops.prefill_into_pages(jnp.asarray(k), jnp.asarray(v), T, extra_pages, pad_pages_to)
    got = ops.prefill_into_pages(torch.from_numpy(k), torch.from_numpy(v), T, extra_pages, pad_pages_to)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
