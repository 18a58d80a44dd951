"""Port model vs the JAX package on ``get_config("llama3_2-1b").smoke()``
(and the MoE and vlm families on the mixtral-8x7b and chameleon-34b smoke
configs): weight conversion, layers, prefill and decode logits; plus the
port's import hygiene (it must never pull in JAX or the JAX package)."""

import dataclasses
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.lm import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def configs(arch="llama3_2-1b", **overrides):
    """The same smoke config in both packages."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **overrides)
    tcfg = dataclasses.replace(get_config(arch).smoke(), **overrides)
    return jcfg, tcfg


def jax_params(jcfg):
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------ weights ------------------------------
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(param_dtype):
    jcfg, tcfg = configs(param_dtype=param_dtype)
    pnp = jax_params(jcfg)
    tp = params_from_jax(pnp, tcfg, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(pnp)[0]
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, param_dtype)
        assert tuple(t.shape) == leaf.shape
        back = t.view(torch.int16).numpy().view(leaf.dtype) if param_dtype == "bfloat16" else t.numpy()
        np.testing.assert_array_equal(back, leaf)
    # a port init has the very same structure and shapes
    init = build_model(tcfg).init(seed=0, device="cpu")
    flat_t = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: tuple(t.shape), init,
                                                               is_leaf=lambda x: isinstance(x, torch.Tensor)),
                                                  is_leaf=lambda x: isinstance(x, tuple))[0]
    assert [(jax.tree_util.keystr(p), s) for p, s in flat_t] == [
        (jax.tree_util.keystr(p), leaf.shape) for p, leaf in flat_j
    ]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b", "chameleon-34b"])
def test_params_from_jax_round_trip_moe_and_vlm(arch):
    """MoE blocks cross with the router in f32 and the experts stacked
    (L, E, ...); vlm (bf16 params for chameleon) as a dense decoder."""
    jcfg, tcfg = configs(arch, param_dtype=jax_get_config(arch).param_dtype)
    pnp = jax_params(jcfg)
    tp = params_from_jax(pnp, tcfg, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(pnp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, leaf.dtype.name), path
        back = t.view(torch.int16).numpy().view(leaf.dtype) if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(back, leaf)
    if tcfg.is_moe:
        L, E, d, f = tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff
        ffn = tp["blocks"]["ffn"]
        assert ffn["router"].dtype == torch.float32 and tuple(ffn["router"].shape) == (L, d, E)
        assert tuple(ffn["w1"].shape) == (L, E, d, f) and tuple(ffn["w2"].shape) == (L, E, f, d)
    # the port's own init has the same tree, shapes and dtypes
    init = build_model(tcfg).init(seed=0, device="cpu")
    shapes = lambda tree: [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype).split(".")[-1])  # noqa: E731
                           for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert shapes(init) == shapes(pnp)


@pytest.mark.parametrize("arch", ["llama3_2-1b", "mixtral-8x7b"])
def test_init_in_serving_dtype_draws_the_same_values(arch):
    """``init(dtype=...)`` stores the blocks in that dtype (the MoE router
    kept in f32) with the default init's values cast, so serving_params
    copies nothing; the default init itself still draws the same numbers
    layer by layer."""
    from repro_torch.models.lm import serving_params

    _, tcfg = configs(arch, compute_dtype="bfloat16")
    model = build_model(tcfg)
    full = model.init(seed=0, device="cpu")
    half = model.init(seed=0, device="cpu", dtype=torch.bfloat16)
    torch.testing.assert_close(half["embed"]["table"], full["embed"]["table"], rtol=0, atol=0)
    flat = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]  # noqa: E731
    for (path, h), (_, f) in zip(flat(half["blocks"]), flat(full["blocks"])):
        want_dtype = torch.float32 if path[-1].key == "router" else torch.bfloat16
        assert h.dtype == want_dtype, path
        torch.testing.assert_close(h, f.to(want_dtype), rtol=0, atol=0)
    served = serving_params(half, tcfg)
    for (_, s), (_, h) in zip(flat(served["blocks"]), flat(half["blocks"])):
        assert s is h
    # the draws of an init that stacks whole layers: embedding, then layer by layer
    from repro_torch.models import blocks
    from repro_torch.models.modules import embed_init

    gen = torch.Generator().manual_seed(0)
    embed_init(gen, tcfg.padded_vocab, tcfg.d_model, tcfg.pdtype())
    layers = [blocks.block_init(gen, tcfg) for _ in range(tcfg.n_layers)]
    for path, f in flat(full["blocks"]):
        def leaf(layer, path=path):
            for key in path:
                layer = layer[key.key]
            return layer
        torch.testing.assert_close(f, torch.stack([leaf(x) for x in layers]), rtol=0, atol=0)


def test_params_from_jax_rejects_mismatch():
    jcfg, tcfg = configs()
    pnp = jax_params(jcfg)
    pnp["blocks"]["attn"]["wq"] = pnp["blocks"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(pnp, tcfg, device="cpu")
    del pnp["ln_f"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(pnp, tcfg, device="cpu")


# ------------------------------ layers ------------------------------
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_layers_match_jax(dtype, tol):
    jcfg, tcfg = configs(compute_dtype=dtype)
    rng = np.random.default_rng(0)
    d, f = jcfg.d_model, jcfg.d_ff
    x = rng.standard_normal((2, 5, d), dtype=np.float32)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_allclose(
        as_np(layers.rmsnorm(tx, torch.from_numpy(scale))),
        as_np(jlayers.rmsnorm(jx, jnp.asarray(scale))), rtol=tol, atol=tol,
    )
    h = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    jh, th = jnp.asarray(h).astype(dtype), torch.from_numpy(h).to(getattr(torch, dtype))
    for pos in (np.arange(5)[None, :], np.array([[7], [300]])):
        ph = th[:, : pos.shape[1]]
        np.testing.assert_allclose(
            as_np(layers.apply_rope(ph, torch.from_numpy(pos), jcfg.rope_theta)),
            as_np(jlayers.apply_rope(jh[:, : pos.shape[1]], jnp.asarray(pos), jcfg.rope_theta)),
            rtol=tol, atol=tol,
        )
    w = {k: rng.standard_normal(s, dtype=np.float32) * 0.1
         for k, s in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    np.testing.assert_allclose(
        as_np(layers.mlp({k: torch.from_numpy(v) for k, v in w.items()}, tx, tcfg)),
        as_np(jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()}, jx, jcfg)),
        rtol=tol, atol=tol,
    )


# ------------------------------ prefill + decode ------------------------------
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


# f32 pools: the JAX model's default XLA path, held to 1e-4. bf16 pools: the
# JAX model on its Pallas kernels (interpret mode); K/V are rounded to bf16
# in both, and a 1e-7 difference in f32 can round a cached value to the
# neighbouring bf16 number, so logits are held to 2e-3.
@pytest.mark.parametrize("kv_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_prefill_and_decode_logits_match_jax(kv_dtype, tol, monkeypatch):
    if kv_dtype == "bfloat16":
        _pallas_interpret(monkeypatch)
    jcfg, tcfg = configs(kv_cache_dtype=kv_dtype)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 2 * jcfg.kv_page_tokens))
    check_prefill_and_decode(jcfg, tcfg, tokens, tol, rng)


# mixtral's smoke config keeps its sliding window (32 tokens) and routes
# over 4 experts, top 2: 48-token prompts and three decode steps put the
# window inside the prompt and inside every decode row
@pytest.mark.parametrize("kv_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_moe_prefill_and_decode_logits_match_jax(kv_dtype, tol, monkeypatch):
    if kv_dtype == "bfloat16":
        _pallas_interpret(monkeypatch)
    jcfg, tcfg = configs("mixtral-8x7b", kv_cache_dtype=kv_dtype)
    assert tcfg.is_moe and tcfg.sliding_window == 32
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 6 * jcfg.kv_page_tokens))
    assert tokens.shape[1] > tcfg.sliding_window
    check_prefill_and_decode(jcfg, tcfg, tokens, tol, rng)


def test_vlm_prefill_from_embeddings_matches_jax():
    """chameleon's backbone takes precomputed embeddings (B, S, d) in place
    of tokens; decode steps then take tokens."""
    jcfg, tcfg = configs("chameleon-34b", kv_cache_dtype="float32")
    assert tcfg.family == "vlm" and tcfg.input_kind == "embeds"
    rng = np.random.default_rng(4)
    embeds = rng.standard_normal((2, 2 * jcfg.kv_page_tokens, jcfg.d_model), dtype=np.float32)
    check_prefill_and_decode(jcfg, tcfg, embeds, 1e-4, rng)


def check_prefill_and_decode(jcfg, tcfg, inputs, tol, rng):
    """Prefill ``inputs`` (tokens, or embeddings for a float array) and take
    three decode steps in both packages with the same JAX-initialised
    weights; logits, pools, tables, page_pos and lengths must agree."""
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    pnp = jax_params(jcfg)
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = params_from_jax(pnp, tcfg, device="cpu")
    if inputs.dtype.kind == "f":
        batch = {"embeds": jnp.asarray(inputs)}
    else:
        batch = {"tokens": jnp.asarray(inputs, jnp.int32)}

    jlogits, jcache = jmodel.prefill(jp, batch, None)
    tlogits, tcache = tmodel.prefill(tp, torch.from_numpy(inputs))
    np.testing.assert_allclose(as_np(tlogits), as_np(jlogits), rtol=tol, atol=tol)
    check_pools(tcache["kv"], jcache["kv"], tol)
    for name in ("tables", "page_pos"):
        np.testing.assert_array_equal(tcache["kv"][name].numpy(), np.asarray(jcache["kv"][name]))

    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, inputs.shape[0])
        jlogits, jcache = jmodel.decode_step(jp, jcache, jnp.asarray(nxt, jnp.int32), None)
        tlogits, tcache = tmodel.decode_step(tp, tcache, torch.from_numpy(nxt))
        np.testing.assert_allclose(as_np(tlogits), as_np(jlogits), rtol=tol, atol=tol)
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    np.testing.assert_array_equal(tcache["kv"]["page_pos"].numpy(), np.asarray(jcache["kv"]["page_pos"]))
    check_pools(tcache["kv"], jcache["kv"], tol)


def check_pools(tkv, jkv, tol):
    """Float pools within ``tol``. int8 pools: their f32 scales within
    ``tol``, and each int8 code the JAX one or its neighbour (a 1e-7
    difference in f32 moves a value across a rounding boundary now and
    then), at most one code in 1000 so."""
    assert set(tkv) == set(jkv)
    for name in ("pool_k", "pool_v"):
        got, want = tkv[name], np.asarray(jkv[name])
        if got.dtype != torch.int8:
            np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)
            continue
        assert want.dtype == np.int8
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (name, d.max(), (d > 0).mean())
        scale = "scale_" + name[-1]
        np.testing.assert_allclose(tkv[scale].numpy(), np.asarray(jkv[scale]), rtol=tol, atol=tol)


# mistral-large-123b is the one int8-KV config (96 heads over 8 kv-heads at
# full width: 4 over 2 in the smoke config): JAX on its Pallas kernels in
# interpret mode reads the pools dequantized to bf16, as the port does
def test_int8_kv_prefill_and_decode_logits_match_jax(monkeypatch):
    _pallas_interpret(monkeypatch)
    jcfg, tcfg = configs("mistral-large-123b")
    assert tcfg.kv_cache_dtype == "int8"
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 3 * jcfg.kv_page_tokens))
    check_prefill_and_decode(jcfg, tcfg, tokens, 2e-3, rng)


def test_init_cache_matches_jax():
    jcfg, tcfg = configs(kv_cache_dtype="float32")
    jc = jax_build_model(jcfg).init_cache(3, 4 * jcfg.kv_page_tokens)
    tc = build_model(tcfg).init_cache(3, 4 * tcfg.kv_page_tokens, device="cpu")
    for name in ("pool_k", "pool_v", "tables", "page_pos"):
        np.testing.assert_array_equal(as_np(tc["kv"][name]), as_np(jc["kv"][name]))
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))


def test_int8_init_cache_matches_jax():
    jcfg, tcfg = configs("mistral-large-123b")
    jc = jax_build_model(jcfg).init_cache(3, 4 * jcfg.kv_page_tokens)
    tc = build_model(tcfg).init_cache(3, 4 * tcfg.kv_page_tokens, device="cpu")
    assert set(tc["kv"]) == set(jc["kv"]) and tc["kv"]["pool_k"].dtype == torch.int8
    for name in jc["kv"]:
        np.testing.assert_array_equal(tc["kv"][name].numpy(), np.asarray(jc["kv"][name]))
        assert tc["kv"][name].numpy().dtype == np.asarray(jc["kv"][name]).dtype, name


# every family builds now; the serving engine refuses ssm and hybrid (its
# decode cache carries no SSM state, as the JAX engine's does not) and
# encdec/audio (its requests carry no encoder input): they run through the
# model API
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b", "seamless-m4t-medium"])
def test_unported_families_raise(arch):
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(arch)
    build_model(cfg)
    why = "encoder input" if cfg.family in ("encdec", "audio") else "SSM state"
    cfg = cfg.smoke()
    with pytest.raises(NotImplementedError, match=f"model API only .*{why}"):
        ServingEngine(cfg, build_model(cfg).init(seed=0, device="cpu"), device="cpu")


# ------------------------------ import hygiene ------------------------------
def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serving.engine, repro_torch.launch.serve\n"
        "import repro_torch.convert, repro_torch.kernels.ops, repro_torch.configs\n"
        "import repro_torch.core, repro_torch.serving.blob_kv, repro_torch.models.ssm\n"
        "import repro_torch.parallel.axisinfo, repro_torch.parallel.collectives\n"
        "import repro_torch.parallel.sharding, repro_torch.launch.mesh\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_never_import_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\.|"
                         r"import\s+repro\s*$|from\s+repro\s+import)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
