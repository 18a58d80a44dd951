"""The port's CUDA kernels against their plain PyTorch versions, on a card;
blob mode's pages through the card; the Mamba2 layers, the ssm, hybrid and
encoder-decoder smoke models, the int8 KV path, the rmsnorm autograd
Function and a smoke train step on the card against the CPU; the paged
kernel on a pool striped over two spawned ranks against the unsharded
kernel.

Every test here is marked ``cuda`` and skips where there is no card. On a
machine with one (and ``nvcc``; the kernels build on first use):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

No JAX here: the card's machine need not have it. The plain versions are
held to the JAX package by tests/test_torch_kernels.py on the CPU.
Tolerances: flash 2e-5 (f32) / 2e-2 (bf16), paged 3e-5 / 3e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {"flash": {"float32": 2e-5, "bfloat16": 2e-2}, "paged": {"float32": 3e-5, "bfloat16": 3e-2}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol)


# (B, S, T, H, K, D, window, dtype[, lengths]): lengths are random in [1, S]
# unless given; the last row is always inactive
PAGED_CASES = [
    (2, 64, 8, 4, 4, 64, None, "float32"),
    (2, 64, 8, 4, 1, 128, None, "bfloat16"),
    (2, 128, 16, 4, 4, 32, 48, "float32"),
    (1, 256, 32, 2, 2, 64, 100, "bfloat16"),
    (8, 224, 64, 32, 8, 64, None, "bfloat16"),  # llama3.2-1b serving shape
    (3, 256, 64, 16, 2, 128, None, "float32"),  # 8 heads per kv-head, 512-byte rows
    (8, 4096, 64, 32, 8, 64, None, "bfloat16"),  # 65 pages a row, many per split
    (5, 4096, 64, 32, 8, 64, None, "bfloat16", (4096, 1, 65, 3000, 0)),  # uneven rows
    (4, 4096, 64, 32, 8, 64, 1000, "bfloat16"),  # long rows, window: early pages skipped
    (2, 1024, 64, 16, 2, 128, None, "bfloat16"),  # 8 heads per kv-head, head_dim 128
    (3, 512, 16, 32, 2, 64, None, "float32"),  # 16 heads per kv-head: two chunks of 8
    (3, 300, 16, 4, 2, 16, None, "bfloat16"),  # head_dim 16: 2 lanes a row
    (2, 300, 16, 8, 2, 128, 77, "float32"),  # f32 head_dim 128: a whole warp a row
    (3, 256, 64, 32, 8, 120, None, "bfloat16"),  # h2o-danube-3-4b: 15 of 16 lanes a row
    (3, 256, 64, 32, 8, 120, 100, "float32"),  # 30 of 32 lanes, window
    (3, 256, 64, 32, 32, 80, None, "bfloat16"),  # zamba2-2.7b: 10 of 16 lanes
    (3, 256, 64, 32, 32, 80, 77, "float32"),  # 20 of 32 lanes, window
    (3, 64, 16, 4, 2, 8, None, "bfloat16"),  # head_dim 8: one lane of two
    # mixtral-8x7b decode: rows of 4161-4192 tokens under its 4096-token window
    (9, 4192, 64, 32, 8, 128, 4096, "bfloat16", (4161, 4165, 4170, 4176, 4180, 4185, 4190, 4192, 0)),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_cuda_matches_plain(dev, case):
    B, S, T, H, K, D, window, dtype = case[:8]
    rng = np.random.default_rng(3)
    R = S // T + 1
    P = B * R + 2
    dt = getattr(torch, dtype)
    q, pool_k, pool_v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dt)
                         for s in ((B, H, D), (P, T, K, D), (P, T, K, D)))
    tables = rng.permutation(P)[: B * R].reshape(B, R).astype(np.int32)
    tables[-1] = P  # an inactive row: all sentinel, length 0
    page_pos = np.repeat((np.arange(R, dtype=np.int32) * T)[None], B, axis=0)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    if len(case) > 8:
        lengths[:] = case[8]
    lengths[-1] = 0
    args = [q, pool_k, pool_v] + [torch.from_numpy(a).to(dev) for a in (tables, page_pos, lengths)]
    n = paged_attention_cuda.launches
    o, m, l = paged_attention_cuda(*args, window=window)
    po, pm, pl = paged_attention_plain(*args, window=window)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == n + 1
    assert (o[-1] == 0).all() and (l[-1] == 0).all() and (m[-1] == -1e30).all()
    for g, w in zip((o, m, l), (po, pm, pl)):
        close(g, w, TOL["paged"][dtype])


# (B, Sq, Sk, H, K, D, causal, window, q_start, dtype)
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64, True, None, 0, "float32"),
    (2, 256, 256, 4, 2, 64, True, None, 0, "float32"),
    (1, 128, 128, 8, 1, 128, True, None, 0, "bfloat16"),
    (2, 128, 128, 4, 4, 32, False, None, 0, "float32"),
    (1, 256, 256, 2, 2, 64, True, 64, 0, "float32"),
    (1, 512, 512, 2, 1, 64, True, 128, 0, "bfloat16"),
    (2, 128, 256, 4, 4, 64, False, None, 0, "float32"),
    (1, 192, 192, 32, 8, 64, True, None, 0, "bfloat16"),  # llama3.2-1b prefill shape
    (2, 100, 100, 4, 2, 16, True, 48, 0, "float32"),  # ragged, smoke head_dim
    (1, 64, 192, 4, 1, 32, True, None, 128, "float32"),  # q_start offset
    (2, 100, 100, 4, 2, 16, True, 48, 0, "bfloat16"),  # tensor cores: head_dim 16, ragged
    (1, 64, 192, 4, 1, 32, True, None, 128, "bfloat16"),  # head_dim 32, q_start 128
    (1, 203, 203, 32, 8, 64, True, None, 0, "bfloat16"),  # ragged 203-token prompt
    (2, 100, 150, 8, 2, 64, False, None, 0, "bfloat16"),  # non-causal Sq != Sk
    (2, 200, 200, 16, 4, 128, True, None, 0, "bfloat16"),  # 4 heads a CTA, > 48 KB smem
    (1, 256, 256, 8, 8, 128, True, 100, 0, "bfloat16"),  # window, one head per kv-head
    (1, 200, 200, 32, 8, 120, True, None, 0, "bfloat16"),  # h2o-danube-3-4b: staged at 128
    (1, 200, 200, 32, 8, 120, True, 64, 0, "float32"),
    (2, 130, 130, 32, 32, 80, True, None, 0, "bfloat16"),  # zamba2-2.7b: staged at 128
    (1, 130, 130, 8, 8, 80, True, 48, 0, "float32"),
    (1, 100, 100, 4, 2, 24, True, None, 0, "bfloat16"),  # head_dim 24: staged at 32
    (1, 4160, 4160, 32, 8, 128, True, 4096, 0, "bfloat16"),  # mixtral-8x7b prefill, window cuts
    (2, 200, 2048, 16, 16, 64, False, None, 0, "bfloat16"),  # seamless cross-attention: MHA, ragged Sq != Sk
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_cuda_matches_plain(dev, case):
    B, Sq, Sk, H, K, D, causal, window, q_start, dtype = case
    rng = np.random.default_rng(42)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dt)
               for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)))
    n = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal, window=window, q_start=q_start)
    want = flash_attention_plain(q, k, v, causal=causal, window=window, q_start=q_start)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n + 1
    assert got.dtype == dt
    close(got, want, TOL["flash"][dtype])


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 4, 2, 16), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError, match="device"):
        flash_attention_cuda(q, q.cpu(), q)


@pytest.mark.parametrize("D", [100, 12, 136])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrappers_reject_head_dims_not_a_multiple_of_8(dev, D, dtype):
    dt = getattr(torch, dtype)
    q = torch.zeros((1, 32, 2, D), device=dev, dtype=dt)
    n_flash, n_paged = flash_attention_cuda.launches, paged_attention_cuda.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_cuda(q, q, q)
    pool = torch.zeros((4, 16, 2, D), device=dev, dtype=dt)
    t = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention_cuda(q[:, 0], pool, pool, t, t, t[:, 0].contiguous())
    assert (flash_attention_cuda.launches, paged_attention_cuda.launches) == (n_flash, n_paged)


def test_moe_layer_on_the_card_never_syncs_the_host(dev):
    """The MoE dispatch keeps every index on the device: no host
    synchronisation (a CUDA graph can capture the decode step later), and
    the card's f32 result is the CPU's within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("mixtral-8x7b").smoke()
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 24, cfg.d_model), dtype=np.float32))
    want, want_aux = moe.moe_ffn(params, x, cfg)
    on_card = {k: v.to(dev) for k, v in params.items()}
    xd = x.to(dev)
    moe.moe_ffn(on_card, xd, cfg)  # first call: cuBLAS set-up may synchronise
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = moe.moe_ffn(on_card, xd, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    close(got, want, 1e-4)
    close(aux, want_aux, 1e-5)


# ------------------------------ blob mode ------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_page_moves_through_the_card_byte_for_byte(dev, dtype):
    from repro_torch.serving.engine import load_page, pack_page

    rng = np.random.default_rng(5)
    k, v = (torch.from_numpy(rng.standard_normal((3, 4, 16, 2, 64), dtype=np.float32)).to(dev, getattr(torch, dtype))
            for _ in range(2))
    page_size = 1 << (2 * k[:, 1].numel() * k.element_size() - 1).bit_length()
    buf = pack_page(k[:, 1], v[:, 1], page_size)
    np.testing.assert_array_equal(buf, pack_page(k[:, 1].cpu(), v[:, 1].cpu(), page_size))
    pool_k, pool_v = torch.zeros_like(k), torch.zeros_like(v)
    buf.flags.writeable = False  # as a fetched page is
    load_page(pool_k, pool_v, 2, buf)
    assert torch.equal(pool_k[:, 2], k[:, 1]) and torch.equal(pool_v[:, 2], v[:, 1])
    assert not pool_k[:, 1].any()


def test_blob_engines_on_the_card_match_the_host_allocator_engine(dev):
    """Two blob-mode engines on one store (the second takes the first's
    system-prompt pages from the directory) decode the host-allocator
    engine's tokens, on the card's kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core import Cluster
    from repro_torch.models.lm import build_model
    from repro_torch.serving import BlobKVClient, BlobKVStore, Request, ServingEngine

    cfg = get_config("llama3_2-1b").smoke()
    params = build_model(cfg).init(seed=0, device=dev)
    system = list(range(100, 116))
    bursts = [[Request(8 * b + i, system + [200 + 8 * (8 * b + i) + j for j in range(8)], max_new_tokens=12)
               for i in range(6)] for b in range(2)]
    host = ServingEngine(cfg, params, max_slots=4, n_pages=64, device=dev)
    cluster = Cluster(n_data_providers=2, n_metadata_providers=2)
    try:
        store = BlobKVStore.for_kv(cluster, n_pages=64, page_tokens=cfg.kv_page_tokens, n_layers=cfg.n_layers,
                                   n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, dtype=np.uint16)
        for burst in bursts:
            blob = ServingEngine(cfg, params, max_slots=4, device=dev, kv_client=BlobKVClient(store))
            for r in burst:
                host.submit(r)
                blob.submit(r)
            want, got = host.run_until_drained(), blob.run_until_drained()
            for r in burst:
                assert got[r.request_id].tokens == want[r.request_id].tokens, r.request_id
        assert all(got[r.request_id].prefill_skipped_tokens == len(system) for r in bursts[1])
        assert blob.kv.stats["published_pages"] == 12  # 6 tails, 6 decode pages
    finally:
        cluster.close()


# ------------------------------ state-space models, int8 KV ------------------------------
def _smoke_on_both(arch, dev, **overrides):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    cfg = dataclasses.replace(get_config(arch).smoke(), **overrides)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    return cfg, model, params, _tree_to(params, dev)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _check_ssm_layer(dev):
    """One Mamba2 mixer (f32; 40 tokens run SSD chunks of 10) over a whole
    sequence with its state handoff, then two decode steps: the card's
    result is the CPU's within 1e-4 (TF32 is off for matmuls by default)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("mamba2-370m").smoke()
    params = ssm.ssm_init(torch.Generator().manual_seed(0), cfg)
    card = _tree_to(params, dev)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 40, cfg.d_model), dtype=np.float32))
    want, wstate = ssm.ssm_forward(params, x, cfg, return_state=True)
    got, gstate = ssm.ssm_forward(card, x.to(dev), cfg, return_state=True)
    close(got, want, 1e-4)
    for _ in range(2):
        x1 = torch.randn((2, 1, cfg.d_model), generator=torch.Generator().manual_seed(8))
        want, wstate = ssm.ssm_decode(params, x1, wstate, cfg)
        got, gstate = ssm.ssm_decode(card, x1.to(dev), gstate, cfg)
        close(got, want, 1e-4)
        for name in ("ssm", "conv"):
            close(gstate[name], wstate[name], 1e-4)


def _check_smoke_model(dev, arch):
    """The smoke model (f32, f32 pools) through prefill and three decode
    steps on the card (zamba2's shared block on both CUDA kernels) against
    the CPU (their plain versions): logits and SSM states within 1e-4."""
    cfg, model, params, card = _smoke_on_both(arch, dev, kv_cache_dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 40)))
    n_flash, n_paged = flash_attention_cuda.launches, paged_attention_cuda.launches
    want, wc = model.prefill(params, tokens)
    got, gc = model.prefill(card, tokens.to(dev))
    for step in range(4):
        close(got, want, 1e-4)
        for name in ("ssm", "conv"):
            close(gc["ssm"][name], wc["ssm"][name], 1e-4)
        if step < 3:
            nxt = want.argmax(-1)
            want, wc = model.decode_step(params, wc, nxt)
            got, gc = model.decode_step(card, gc, nxt.to(dev))
    attn_layers = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    assert flash_attention_cuda.launches - n_flash == attn_layers
    assert paged_attention_cuda.launches - n_paged == 3 * attn_layers


def _check_int8_decode(dev):
    """quantize_token on the card is the CPU's bit for bit (bf16 and f32
    tokens); the int8-KV smoke model (mistral-large) prefills and decodes
    three steps on the card, the paged kernel reading the dequantized pool:
    int8 codes the CPU's or their neighbours, logits within 2e-3."""
    from repro_torch.kernels import ops

    x = torch.from_numpy(np.random.default_rng(10).standard_normal((64, 16, 8, 128), dtype=np.float32) * 3)
    for t in (x, x.to(torch.bfloat16)):
        (wq, ws), (gq, gs) = ops.quantize_token(t), ops.quantize_token(t.to(dev))
        assert torch.equal(gq.cpu(), wq) and torch.equal(gs.cpu(), ws)
        assert torch.equal(ops.dequantize_pool(gq, gs).cpu(), ops.dequantize_pool(wq, ws))

    cfg, model, params, card = _smoke_on_both("mistral-large-123b", dev)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 24)))
    n_paged = paged_attention_cuda.launches
    want, wc = model.prefill(params, tokens)
    got, gc = model.prefill(card, tokens.to(dev))
    for step in range(4):
        close(got, want, 2e-3)
        for name in ("pool_k", "pool_v"):
            d = (gc["kv"][name].cpu().int() - wc["kv"][name].int()).abs()
            assert gc["kv"][name].dtype == torch.int8 and d.max() <= 1 and (d > 0).float().mean() <= 1e-3
            close(gc["kv"]["scale_" + name[-1]], wc["kv"]["scale_" + name[-1]], 1e-4)
        if step < 3:
            nxt = want.argmax(-1)
            want, wc = model.decode_step(params, wc, nxt)
            got, gc = model.decode_step(card, gc, nxt.to(dev))
    assert paged_attention_cuda.launches - n_paged == 3 * cfg.n_layers


def _check_int8_update_syncs(dev):
    """``paged_update`` makes no host synchronisation, with a row whose
    page is not local (dropped) and in its int8 branch (quantize, write
    codes and scales); counted by the sync debug mode's warnings."""
    import warnings

    from repro_torch.kernels import ops

    B, T, K, D, R = 4, 16, 2, 64, 3
    tables = torch.arange(B * R, dtype=torch.int32, device=dev).reshape(B, R)
    tables[0] = B * R  # a row whose page is not local: dropped
    page_pos = (torch.arange(R, dtype=torch.int32, device=dev) * T)[None].repeat(B, 1)
    lengths = torch.tensor([3, 5, 17, 40], dtype=torch.int32, device=dev)
    new = torch.randn((B, K, D), device=dev)
    syncs = {}
    for dtype in (torch.bfloat16, torch.int8):
        pools = [torch.zeros((B * R, T, K, D), dtype=dtype, device=dev) for _ in range(2)]
        kw = {}
        if dtype == torch.int8:
            kw = dict(scale_k=torch.zeros((B * R, T, K), device=dev), scale_v=torch.zeros((B * R, T, K), device=dev))
        ops.paged_update(*pools, tables, page_pos, lengths, new, new, **kw)  # first call: set-up
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ops.paged_update(*pools, tables, page_pos, lengths, new, new, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs[dtype] = sum("synchroniz" in str(w.message) for w in caught)
    assert syncs[torch.int8] == syncs[torch.bfloat16] == 0, syncs


def test_state_space_layers_and_models_on_the_card_match_the_cpu(dev):
    _check_ssm_layer(dev)
    for arch in ("mamba2-370m", "zamba2-2.7b"):
        _check_smoke_model(dev, arch)


def test_int8_kv_on_the_card_matches_the_cpu(dev):
    _check_int8_decode(dev)
    _check_int8_update_syncs(dev)


def test_encdec_smoke_model_on_the_card_matches_the_cpu(dev):
    """seamless-m4t-medium's smoke model (f32, f32 pools): prefill of 32
    encoder frames and 16 decoder tokens, then three decode steps, on the
    card (non-causal and cross flash, read-only paged decode) against the
    CPU within 1e-4; every attention call went through a kernel, and
    decode never wrote the cross pools."""
    cfg, model, params, card = _smoke_on_both("seamless-m4t-medium", dev, kv_cache_dtype="float32")
    rng = np.random.default_rng(12)
    batch = {"enc_embeds": torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))}
    n_flash, n_paged = flash_attention_cuda.launches, paged_attention_cuda.launches
    want, wc = model.prefill(params, batch)
    got, gc = model.prefill(card, {k: v.to(dev) for k, v in batch.items()})
    assert flash_attention_cuda.launches - n_flash == cfg.n_enc_layers + 2 * cfg.n_dec_layers
    cross = {n: t.clone() for n, t in gc["cross_kv"].items()}
    for step in range(4):
        close(got, want, 1e-4)
        for part in ("self_kv", "cross_kv"):
            for name in ("pool_k", "pool_v"):
                close(gc[part][name], wc[part][name], 1e-4)
        if step < 3:
            nxt = want.argmax(-1)
            want, wc = model.decode_step(params, wc, nxt)
            got, gc = model.decode_step(card, gc, nxt.to(dev))
    assert paged_attention_cuda.launches - n_paged == 3 * 2 * cfg.n_dec_layers
    assert all(torch.equal(gc["cross_kv"][n], t) for n, t in cross.items())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_rmsnorm_function_on_the_card_matches_the_cpu(dev, dtype, tol):
    """The rmsnorm autograd Function's output, dx and dscale."""
    from repro_torch.models.layers import rmsnorm

    rng = np.random.default_rng(13)
    x, g = (torch.from_numpy(rng.standard_normal((4, 33, 256), dtype=np.float32)).to(getattr(torch, dtype))
            for _ in range(2))
    s = torch.from_numpy(rng.standard_normal(256, dtype=np.float32))
    outs = []
    for d in ("cpu", dev):
        xd, sd = x.to(d).requires_grad_(True), s.to(d).requires_grad_(True)
        y = rmsnorm(xd, sd)
        outs.append((y.detach(), *torch.autograd.grad(y, (xd, sd), g.to(d))))
    for want, got in zip(*outs):
        assert got.dtype == want.dtype
        close(got, want, tol)


def test_smoke_train_step_on_the_card_matches_the_cpu(dev):
    """One train step (4 microbatches) of llama3_2-1b's smoke config from
    the same weights and batch: the loss within 1e-5 and the step's first
    moment (linear in the gradient) within 1e-4 of each leaf's largest; no
    CUDA kernel runs in training."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    cfg = get_config("llama3_2-1b").smoke()
    model = build_model(cfg)
    params0 = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(14)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32))
             for k in ("tokens", "labels")}
    n = (flash_attention_cuda.launches, paged_attention_cuda.launches)
    runs = []
    for d in ("cpu", dev):
        params = _copy(params0, d)
        step = make_train_step(model, cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
        _, opt_state, metrics = step(params, adamw_init(params), {k: v.to(d) for k, v in batch.items()})
        runs.append((float(metrics["loss"]), _flat(opt_state["m"])))
    (want_loss, want_m), (loss, m) = runs
    assert abs(loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    for path, w in want_m.items():
        assert float((m[path].cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max()), path
    assert (flash_attention_cuda.launches, paged_attention_cuda.launches) == n


def _copy(tree, dev):
    if isinstance(tree, dict):
        return {k: _copy(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], path + (k,)).items()}
    return {path: tree}


def test_sky_detector_on_the_card_matches_numpy(dev):
    """Difference imaging of 8 regions of 2048^2 f32 on the card, directly
    and from read-only ``readv``-like windows through a pinned staging
    buffer on the detector's own stream, against numpy's
    ``detect_transients`` region by region, exactly."""
    from repro_torch.data.detect import DeviceDetector, detect_transients_batched
    from repro_torch.data.sky import detect_transients

    R, px, page = 8, 2048, 64 << 10
    rng = np.random.default_rng(18)
    before = rng.normal(0, 1, (R, px, px)).astype(np.float32)
    after = before + rng.normal(0, 1, (R, px, px)).astype(np.float32)
    for r in range(0, R, 2):  # odd regions stay empty
        ys, xs = rng.integers(0, px, 40 * (r + 1)), rng.integers(0, px, 40 * (r + 1))
        after[r, ys, xs] = before[r, ys, xs] + rng.uniform(100, 900, ys.size).astype(np.float32)
    after[0, 5, 7] = before[0, 5, 7] = 0.0
    after[0, 5, 7] += np.float32(150.0)  # exactly the threshold: not a hit
    after[2, 9, 9] = before[2, 9, 9] - np.float32(500.0)  # dimmed: not a hit
    want = [detect_transients(before[r], after[r], threshold=150.0) for r in range(R)]
    assert sum(map(len, want)) > 500 and not want[1]
    got = detect_transients_batched(torch.from_numpy(before).to(dev), torch.from_numpy(after).to(dev), 150.0)
    assert got == want

    def windows(frames):
        out = []
        for img in frames:
            w = np.zeros(img.nbytes + page, np.uint8)
            w[: img.nbytes] = img.reshape(-1).view(np.uint8)
            w.flags.writeable = False
            out.append(w)
        return out

    det = DeviceDetector(R, px, dev)
    assert det.staging.is_pinned()
    assert det.detect(windows(before), windows(after), 150.0) == want
    assert det.tensor_device.type == "cuda" and len(det.spans) == 1
    e0, e1, e2 = det.spans[0]
    assert 0 < e0.elapsed_time(e1) and 0 < e1.elapsed_time(e2)


# ------------------------------ the pool striped over ranks ------------------------------
def _sharded_paged_rank(ai, chosen, case):
    """This rank's stripe of the pool through ``ops.paged_attention`` with
    the page axes (kernel, then the combine over gloo or NCCL)."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.axisinfo import page_offset_in_shard

    q, pool_k, pool_v, tables, page_pos, lengths = (torch.from_numpy(a).to(chosen.device) for a in case)
    q, pool_k, pool_v = (t.view(torch.bfloat16) for t in (q, pool_k, pool_v))
    pl = pool_k.shape[0] // ai.n_page_shards
    off = page_offset_in_shard(ai.page_axes, pl, ai.mesh)
    paged_attention_cuda.launches = 0
    out = ops.paged_attention(q, pool_k[off:off + pl], pool_v[off:off + pl], tables, page_pos, lengths,
                              page_offset=off, axis_names=ai.page_axes, mesh=ai.mesh)
    torch.cuda.synchronize()
    return {"out": out.float().cpu(), "launches": paged_attention_cuda.launches, "backend": chosen.backend}


def test_sharded_paged_attention_on_the_card_matches_the_unsharded_kernel(dev):
    """llama3.2-1b's decode shape (8 rows of 2048-2080 tokens, 32 heads over
    8 kv-heads of 64, bf16 pool of 8 x 33 pages) striped over 2 ranks on
    the card: each rank launches the kernel once on its stripe (a
    ``page_offset`` of 0 or 132) and the combined output matches the
    unsharded kernel within 1e-2: the ranks' f32 (o, l) are merged in
    another order than the kernel's splits, and the bf16 output may round
    one step (2^-8 of a value under 2) the other way."""
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import mesh as launch_mesh

    _build.build_all()  # once here: each spawned rank only loads the libraries
    rng = np.random.default_rng(20)
    B, H, K, D, T, R = 8, 32, 8, 64, 64, 33
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy()  # noqa: E731
    q = bf16(rng.standard_normal((B, H, D), dtype=np.float32))
    pool_k = bf16(rng.standard_normal((B * R, T, K, D), dtype=np.float32))
    pool_v = bf16(rng.standard_normal((B * R, T, K, D), dtype=np.float32))
    tables = rng.permutation(B * R).astype(np.int32).reshape(B, R)  # rows straddle the ranks
    page_pos = np.tile(np.arange(R, dtype=np.int32) * T, (B, 1))
    lengths = np.array([2048, 2049, 2055, 2060, 2066, 2071, 2075, 2080], np.int32)
    case = (q, pool_k, pool_v, tables, page_pos, lengths)
    res = launch_mesh.spawn(_sharded_paged_rank, 2, (case,), model_parallel=2, device="cuda", timeout_s=300)
    args = [torch.from_numpy(a).to(dev) for a in case]
    args[:3] = [t.view(torch.bfloat16) for t in args[:3]]
    want = ops.paged_attention(*args)
    for r in res:
        assert r["launches"] == 1 and r["backend"] == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
        close(r["out"], want, 1e-2)
        assert torch.equal(r["out"], res[0]["out"])
