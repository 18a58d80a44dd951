"""Port encoder-decoder (``encdec``/``audio``) vs the JAX package on
``seamless-m4t-medium``'s ``.smoke()`` config (2 + 2 layers, d_model 64, 4
heads of 16, 8-token pages): the attention variants it adds (non-causal,
cross with ``kv_src``, no RoPE, read-only paged decode), weight round trips,
prefill with and without decoder tokens then three decode steps, the cache
of ``init_cache``, the port's own teacher-forced continuation, and the
engine's refusal.

Inputs are made with numpy from a seed; JAX weights cross through
``params_from_jax``. S_enc = 32 and S_dec = 16: the Pallas flash wrapper
asserts ``Sq % min(128, Sq) == 0``, and both are whole pages.

Tolerances: attention 1e-5 in f32; logits and pools 1e-4 with f32 pools
(the JAX model's default path); with bf16 pools (JAX on its Pallas kernels
in interpret mode, as tests/test_torch_model.py) logits 2e-3 and pools one
bf16 rounding step (:func:`check_cache`); continuation 2e-2
(tests/test_arch_smoke.py's).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.lm import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402

ARCH = "seamless-m4t-medium"
S_ENC, S_DEC = 32, 16


def configs(**overrides):
    jcfg = dataclasses.replace(jax_get_config(ARCH).smoke(), **overrides)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(), **overrides)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def jax_params(param_dtype="float32"):
    jcfg, _ = configs(param_dtype=param_dtype)
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def _pallas_interpret(monkeypatch):
    """Run the JAX model on its Pallas kernels in interpret mode: its default
    XLA decode path casts q to the pool dtype, its kernels do not."""
    def force(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            return fn(*args, **{**kw, "impl": "pallas", "interpret": True})
        return wrapped

    monkeypatch.setattr(jops, "flash_attention", force(jops.flash_attention))
    monkeypatch.setattr(jops, "paged_attention", force(jops.paged_attention))


def test_seamless_is_the_audio_family_with_its_published_shapes():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.input_kind, cfg.n_enc_layers, cfg.n_dec_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        "audio", "encdec", 12, 12, 1024, 16, 16, 64, 4096, 256206)
    build_model(cfg)  # builds, full size (nothing is allocated)


# ------------------------------ weights ------------------------------
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(param_dtype):
    """Every leaf crosses bit for bit; the port's own init has the JAX
    tree's structure, shapes and dtypes."""
    _, tcfg = configs(param_dtype=param_dtype)
    pnp = jax_params(param_dtype)
    tp = params_from_jax(pnp, tcfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(pnp)[0]
    assert {p[0].key for p, _ in flat} == {"embed", "encoder", "decoder", "ln_enc", "ln_dec"}
    for path, leaf in flat:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, param_dtype), path
        back = t.view(torch.int16).numpy().view(leaf.dtype) if param_dtype == "bfloat16" else t.numpy()
        np.testing.assert_array_equal(back, leaf)
    shapes = lambda tree: [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype).split(".")[-1])  # noqa: E731
                           for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert shapes(build_model(tcfg).init(seed=0, device="cpu")) == shapes(pnp)
    half = build_model(tcfg).init(seed=0, device="cpu", dtype=torch.bfloat16)
    assert {x.dtype for x in jax.tree.leaves(half["decoder"]) + [half["ln_enc"]]} == {torch.bfloat16}


# ------------------------------ attention variants ------------------------------
@pytest.mark.parametrize("variant", ["non-causal", "cross", "no-rope", "no-rope non-causal"])
def test_attention_train_variants_match_jax(variant):
    jcfg, tcfg = configs()
    rng = np.random.default_rng(5)
    d = jcfg.d_model
    x = rng.standard_normal((2, S_DEC, d), dtype=np.float32)
    kv_src = rng.standard_normal((2, S_ENC, d), dtype=np.float32)
    p = jax.tree.map(lambda a: a[0], jax_params()["decoder"]["cross"])
    kw = {"non-causal": dict(causal=False), "cross": dict(kv_src=kv_src),
          "no-rope": dict(rope=False), "no-rope non-causal": dict(causal=False, rope=False)}[variant]
    want, (jk, jv) = jattn.attention_train(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, return_kv=True,
        **{k: jnp.asarray(v) if k == "kv_src" else v for k, v in kw.items()})
    got, (tk, tv) = attn.attention_train(
        {k: torch.tensor(v) for k, v in p.items()}, torch.from_numpy(x), tcfg, return_kv=True,
        **{k: torch.from_numpy(v) if k == "kv_src" else v for k, v in kw.items()})
    close(got, want, 1e-5)
    close(tk, jk, 1e-5)
    close(tv, jv, 1e-5)
    if variant == "cross":
        assert tuple(tk.shape) == (2, S_ENC, tcfg.n_kv_heads, tcfg.head_dim)


def test_read_only_attention_decode_matches_jax_and_writes_nothing():
    """``update=False, rope=False`` (cross-attention decode) reads ``lengths``
    tokens of a prefilled pool, not ``lengths + 1``, and hands the cache
    back bit for bit."""
    jcfg, tcfg = configs(kv_cache_dtype="float32")
    rng = np.random.default_rng(6)
    T, K, hd = jcfg.kv_page_tokens, jcfg.n_kv_heads, jcfg.head_dim
    k = rng.standard_normal((3, S_ENC, K, hd), dtype=np.float32)
    v = rng.standard_normal((3, S_ENC, K, hd), dtype=np.float32)
    jpool = dict(zip(("pool_k", "pool_v", "tables", "page_pos"),
                     jops.prefill_into_pages(jnp.asarray(k), jnp.asarray(v), T, extra_pages=1)))
    tpool = {n: torch.from_numpy(np.array(a)) for n, a in jpool.items()}
    before = {n: t.clone() for n, t in tpool.items()}
    lengths = np.array([S_ENC, S_ENC - 5, 9], np.int32)  # the last rows read part of the pool
    x = rng.standard_normal((3, 1, jcfg.d_model), dtype=np.float32)
    p = jax.tree.map(lambda a: a[1], jax_params()["decoder"]["cross"])
    want, jcache = jattn.attention_decode(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jpool,
                                          jnp.asarray(lengths), jcfg, None, update=False, rope=False)
    got, tcache = attn.attention_decode({n: torch.tensor(a) for n, a in p.items()}, torch.from_numpy(x),
                                        tpool, torch.from_numpy(lengths), tcfg, update=False, rope=False)
    close(got, want, 1e-5)
    assert set(tcache) == set(jcache) == set(before)
    for n, t in tcache.items():
        assert torch.equal(t, before[n]), n
        np.testing.assert_array_equal(t.numpy(), np.asarray(jcache[n]))


# ------------------------------ the model ------------------------------
def _inputs(jcfg, seed, with_tokens=True):
    rng = np.random.default_rng(seed)
    batch = {"enc_embeds": rng.standard_normal((2, S_ENC, jcfg.d_model), dtype=np.float32)}
    if with_tokens:
        batch["tokens"] = rng.integers(0, jcfg.vocab_size, (2, S_DEC)).astype(np.int32)
    return batch, rng


def check_cache(tc, jc, tol):
    """Both packages' encdec caches: float pools within ``tol``, bf16 pools
    within one rounding step of the value plus 1e-5 (a 1e-7 difference in
    f32 can round a K/V value to the neighbouring bf16 number, as in
    tests/test_torch_ssm.py); tables, page_pos and lengths equal."""
    assert set(tc) == set(jc) == {"self_kv", "cross_kv", "lengths", "enc_len"}
    for part in ("self_kv", "cross_kv"):
        assert set(tc[part]) == set(jc[part]), part
        for name in ("pool_k", "pool_v"):
            got, want = tc[part][name], jc[part][name]
            assert got.dtype == getattr(torch, np.asarray(want).dtype.name)
            if got.dtype == torch.bfloat16:
                np.testing.assert_allclose(as_np(got), as_np(want), rtol=2 ** -7, atol=1e-5)
            else:
                close(got, want, tol)
        for name in ("tables", "page_pos"):
            np.testing.assert_array_equal(tc[part][name].numpy(), np.asarray(jc[part][name]))
    for name in ("lengths", "enc_len"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def check_prefill_and_decode(kv_dtype, tol, with_tokens, seed):
    jcfg, tcfg = configs(kv_cache_dtype=kv_dtype)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    pnp = jax_params()
    jp, tp = jax.tree.map(jnp.asarray, pnp), params_from_jax(pnp, tcfg, device="cpu")
    batch, rng = _inputs(jcfg, seed, with_tokens)
    jlogits, jcache = jmodel.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    tlogits, tcache = tmodel.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    close(tlogits, jlogits, tol)
    check_cache(tcache, jcache, tol)
    cross = {n: t.clone() for n, t in tcache["cross_kv"].items()}
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, 2).astype(np.int32)
        jlogits, jcache = jmodel.decode_step(jp, jcache, jnp.asarray(nxt), None)
        tlogits, tcache = tmodel.decode_step(tp, tcache, torch.from_numpy(nxt))
        close(tlogits, jlogits, tol)
    check_cache(tcache, jcache, tol)
    for n, t in tcache["cross_kv"].items():  # decode never writes the cross pools
        assert torch.equal(t, cross[n]), n
    return tlogits


@pytest.mark.parametrize("kv_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_prefill_with_tokens_and_decode_match_jax(kv_dtype, tol, monkeypatch):
    if kv_dtype == "bfloat16":
        _pallas_interpret(monkeypatch)
    check_prefill_and_decode(kv_dtype, tol, with_tokens=True, seed=1)


@pytest.mark.parametrize("kv_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_encode_only_prefill_and_decode_match_jax(kv_dtype, tol, monkeypatch):
    """No decoder tokens: zero logits, an empty self cache (lengths 0);
    decoding starts at position 0."""
    if kv_dtype == "bfloat16":
        _pallas_interpret(monkeypatch)
    _, tcfg = configs(kv_cache_dtype=kv_dtype)
    batch, _ = _inputs(tcfg, 2, with_tokens=False)
    logits, cache = build_model(tcfg).prefill(params_from_jax(jax_params(), tcfg, device="cpu"),
                                              {"enc_embeds": torch.from_numpy(batch["enc_embeds"])})
    assert tuple(logits.shape) == (2, tcfg.padded_vocab) and not logits.any()
    assert cache["lengths"].tolist() == [0, 0] and cache["enc_len"].tolist() == [S_ENC, S_ENC]
    check_prefill_and_decode(kv_dtype, tol, with_tokens=False, seed=2)


def test_decode_continues_a_longer_prefill():
    """Prefill of 8 decoder tokens plus 8 teacher-forced decode steps (the
    headroom page) reaches the logits of a 16-token prefill."""
    _, tcfg = configs()
    model = build_model(tcfg)
    params = params_from_jax(jax_params(), tcfg, device="cpu")
    batch, _ = _inputs(tcfg, 3)
    enc, tokens = torch.from_numpy(batch["enc_embeds"]), torch.from_numpy(batch["tokens"]).long()
    want, _ = model.prefill(params, {"enc_embeds": enc, "tokens": tokens})
    cut = S_DEC // 2
    logits, cache = model.prefill(params, {"enc_embeds": enc, "tokens": tokens[:, :cut]})
    for i in range(cut, S_DEC):
        logits, cache = model.decode_step(params, cache, tokens[:, i])
    close(logits, want, 2e-2)
    assert cache["lengths"].tolist() == [S_DEC, S_DEC]


def test_init_cache_matches_jax():
    jcfg, tcfg = configs(kv_cache_dtype="float32")
    jc = jax_build_model(jcfg).init_cache(3, 4 * jcfg.kv_page_tokens)
    tc = build_model(tcfg).init_cache(3, 4 * tcfg.kv_page_tokens, device="cpu")
    assert set(tc) == set(jc)
    for part in ("self_kv", "cross_kv"):
        assert set(tc[part]) == set(jc[part])
        for name, t in tc[part].items():
            np.testing.assert_array_equal(as_np(t), as_np(jc[part][name]))
            assert t.numpy().dtype == np.asarray(jc[part][name]).dtype, name
    for name in ("lengths", "enc_len"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
        assert tc[name].dtype == torch.int32


def test_encoder_length_must_be_whole_pages():
    _, tcfg = configs()
    model = build_model(tcfg)
    params = model.init(seed=0, device="cpu")
    enc = torch.zeros((1, S_ENC + 3, tcfg.d_model))
    with pytest.raises(ValueError, match="multiple of the page size"):
        model.prefill(params, {"enc_embeds": enc})


def test_engine_refuses_encdec():
    """The JAX engine takes the config and fails at its first admit; the
    port's refuses it at construction and names the model API."""
    from repro_torch.serving.engine import ServingEngine

    _, tcfg = configs()
    with pytest.raises(NotImplementedError, match="model API"):
        ServingEngine(tcfg, build_model(tcfg).init(seed=0, device="cpu"), device="cpu")
