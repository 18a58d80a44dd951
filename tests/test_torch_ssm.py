"""Port Mamba2 (``repro_torch.models.ssm``) and the ``ssm`` and ``hybrid``
families vs the JAX package: the SSD scan, conv, decode step and gated norm
on inputs made with numpy from a seed; ``mamba2-370m`` and ``zamba2-2.7b``
``.smoke()`` models through ``prefill`` and three ``decode_step``s with the
JAX-initialised weights (crossing through ``params_from_jax``); the port's
own teacher-forced continuation (tests/test_arch_smoke.py's counterpart);
weight round trips.

Tolerances: the SSD pieces 1e-5 in f32, 2e-2 with bf16 operands; smoke
logits and SSM states 1e-4 with f32 pools, 2e-3 with bf16 pools (JAX on its
Pallas kernels in interpret mode); continuation 2e-2 (test_arch_smoke's).
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
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.lm import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import blocks, ssm  # noqa: E402
from repro_torch.models.lm import build_model, serving_params  # noqa: E402

F32_LEAVES = ("A_log", "D", "dt_bias")


def configs(arch, **overrides):
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **overrides)
    tcfg = dataclasses.replace(get_config(arch).smoke(), **overrides)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch, param_dtype):
    jcfg, _ = configs(arch, param_dtype=param_dtype)
    model = jax_build_model(jcfg)
    params = jax.jit(lambda key: model.init(key)[0])(jax.random.PRNGKey(0))  # jit: 4x faster here
    return jax.tree.map(np.asarray, params)


def jax_params(arch, param_dtype="float32"):
    return _jax_params(arch, param_dtype)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def both(x: np.ndarray, dtype="float32"):
    return jnp.asarray(x).astype(dtype), torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


# ------------------------------ the SSD scan ------------------------------
def ssd_inputs(seed, Bb, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bb, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S, H)).astype(np.float32) - 1.0))  # softplus
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32)
    Bm = rng.standard_normal((Bb, S, G, N), dtype=np.float32)
    Cm = rng.standard_normal((Bb, S, G, N), dtype=np.float32)
    s0 = rng.standard_normal((Bb, H, N, P), dtype=np.float32)
    return x, dt, A, Bm, Cm, s0


# (S, chunk, G, init_state, return_state): S a multiple of the chunk; S not
# a multiple (40 tokens run chunks of 10); two groups; a carried-in state;
# the final state returned
SSD_CASES = [
    (64, 16, 1, False, False),
    (40, 16, 1, False, True),
    (48, 16, 2, False, True),
    (32, 8, 1, True, False),
    (24, 16, 1, True, True),
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_jax(case):
    S, chunk, G, with_init, ret = case
    x, dt, A, Bm, Cm, s0 = ssd_inputs(0, 2, S, 4, 8, G, 6)
    kw = dict(return_state=ret)
    jout = jax.jit(jssm.ssd_chunked, static_argnums=5, static_argnames="return_state")(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
        init_state=jnp.asarray(s0) if with_init else None, **kw)
    tout = ssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk,
                           init_state=torch.from_numpy(s0) if with_init else None, **kw)
    if not ret:
        jout, tout = (jout,), (tout,)
    for t, j in zip(tout, jout):
        assert t.dtype == torch.float32
        close(t, j, 1e-5)
    assert ssm.chunk_len(40, 16) == 10 and ssm.chunk_len(1984, 256) == 248


def test_ssd_chunked_bf16_operands_match_jax():
    """x, B and C in bf16 (the compute dtype), dt and A in f32: the three
    einsums JAX asks for an f32 result run on f32-upcast operands."""
    x, dt, A, Bm, Cm, _ = ssd_inputs(1, 2, 64, 4, 8, 1, 6)
    jx, tx = both(x, "bfloat16")
    jb, tb = both(Bm, "bfloat16")
    jc, tc = both(Cm, "bfloat16")
    want, wstate = jax.jit(jssm.ssd_chunked, static_argnums=(5, 7))(
        jx, jnp.asarray(dt), jnp.asarray(A), jb, jc, 16, None, True)
    got, gstate = ssm.ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc, 16, return_state=True)
    assert got.dtype == torch.float32 and gstate.dtype == torch.float32
    close(got, want, 2e-2)
    close(gstate, wstate, 2e-2)


def test_segsum_and_causal_conv_match_jax():
    rng = np.random.default_rng(2)
    a = -np.abs(rng.standard_normal((2, 3, 16), dtype=np.float32))
    want, got = jssm._segsum(jnp.asarray(a)), ssm._segsum(torch.from_numpy(a))
    assert np.isneginf(as_np(got)).sum() == np.isneginf(np.asarray(want)).sum() == 2 * 3 * 120
    finite = np.isfinite(np.asarray(want))
    close(as_np(got)[finite], np.asarray(want)[finite], 1e-5)
    xbc = rng.standard_normal((2, 11, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    b = rng.standard_normal((24,), dtype=np.float32)
    close(ssm._causal_conv(*(torch.from_numpy(t) for t in (xbc, w, b))),
          jssm._causal_conv(*(jnp.asarray(t) for t in (xbc, w, b))), 1e-5)


def test_ssd_decode_step_and_gated_norm_match_jax():
    rng = np.random.default_rng(3)
    Bb, H, P, G, N = 3, 4, 8, 2, 6
    state = rng.standard_normal((Bb, H, N, P), dtype=np.float32)
    x = rng.standard_normal((Bb, H, P), dtype=np.float32)
    dt = rng.uniform(0.1, 1.0, (Bb, H)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((Bb, G, N), dtype=np.float32)
    Cm = rng.standard_normal((Bb, G, N), dtype=np.float32)
    args = (state, x, dt, A, Bm, Cm)
    for g, w in zip(ssm.ssd_decode_step(*(torch.from_numpy(a) for a in args)),
                    jssm.ssd_decode_step(*(jnp.asarray(a) for a in args))):
        close(g, w, 1e-5)
    y = rng.standard_normal((2, 5, 32), dtype=np.float32)
    z = rng.standard_normal((2, 5, 32), dtype=np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    close(ssm._gated_norm(*(torch.from_numpy(t) for t in (y, z, scale))),
          jssm._gated_norm(*(jnp.asarray(t) for t in (y, z, scale))), 1e-5)


def test_ssm_forward_and_decode_match_jax():
    """One mixer layer of the mamba2 smoke config: the whole sequence
    (28 tokens: chunks of 14), then two one-token steps from a random
    state; and the same layer as a block (pre-norm plus residual)."""
    jcfg, tcfg = configs("mamba2-370m")
    block = jax.tree.map(lambda t: t[0], jax_params("mamba2-370m")["blocks"])
    layer = block["ssm"]
    jp = jax.tree.map(jnp.asarray, layer)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 28, tcfg.d_model), dtype=np.float32)
    jforward = jax.jit(lambda p, x: jssm.ssm_forward(p, x, jcfg))
    jdecode = jax.jit(lambda p, x, st: jssm.ssm_decode(p, x, st, jcfg))
    close(ssm.ssm_forward(tp, torch.from_numpy(x), tcfg), jforward(jp, jnp.asarray(x)), 1e-5)
    jblock = jax.tree.map(jnp.asarray, block)
    tblock = {"ln": torch.from_numpy(np.array(block["ln"])), "ssm": tp}
    close(blocks.ssm_block_apply(tblock, torch.from_numpy(x), tcfg),
          jax.jit(lambda p, x: jblocks.ssm_block_apply(p, x, jcfg))(jblock, jnp.asarray(x)), 1e-5)
    state = {"ssm": rng.standard_normal((2, tcfg.ssm_heads, tcfg.ssm_state, tcfg.ssm_headdim), dtype=np.float32),
             "conv": rng.standard_normal((2, tcfg.ssm_conv - 1, tcfg.d_inner + 2 * tcfg.ssm_state),
                                         dtype=np.float32)}
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    tst = {k: torch.from_numpy(v) for k, v in state.items()}
    for t in range(2):
        x1 = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
        jy, jst = jdecode(jp, jnp.asarray(x1), jst)
        ty, tst = ssm.ssm_decode(tp, torch.from_numpy(x1), tst, tcfg)
        close(ty, jy, 1e-5)
        for k in state:
            close(tst[k], jst[k], 1e-5)
    jy, _ = jblocks.ssm_block_decode(jblock, jnp.asarray(x1), jst, jcfg)
    ty, _ = blocks.ssm_block_decode(tblock, torch.from_numpy(x1), tst, tcfg)
    close(ty, jy, 1e-5)


# ------------------------------ prefill + decode ------------------------------
def _pallas_interpret(monkeypatch):
    def force(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            return fn(*args, **{**kw, "impl": "pallas", "interpret": True})
        return wrapped

    monkeypatch.setattr(jops, "flash_attention", force(jops.flash_attention))
    monkeypatch.setattr(jops, "paged_attention", force(jops.paged_attention))


def check_smoke(arch, tol, *, scaled_states=False, **overrides):
    """Prefill 2 rows of 40 tokens (5 pages; SSD chunks of 10) and take
    three decode steps in both packages. Logits are held to ``tol``; SSM
    states to ``tol`` too, or, with ``scaled_states``, max |d| to ``tol``
    over 1 + max |JAX state| (bf16 compute rounds the conv tail to bf16 at
    values up to 4). Paged KV is held to ``tol`` in f32 and in bf16 to one
    rounding step of the value plus 1e-5 (a 1e-7 difference in f32 can
    round a K/V value to the neighbouring bf16 number); tables, page_pos and
    lengths exactly.
    Returns the largest logit difference and the largest scaled state
    difference seen."""
    jcfg, tcfg = configs(arch, **overrides)
    pnp = jax_params(arch)
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = params_from_jax(pnp, tcfg, device="cpu")
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 40))
    worst = {"logits": 0.0, "states": 0.0}

    def held(tl, tc, jl, jc):
        close(tl, jl, tol)
        worst["logits"] = max(worst["logits"], np.abs(as_np(tl) - as_np(jl)).max())
        for name in ("ssm", "conv"):
            got, want = as_np(tc["ssm"][name]), as_np(jc["ssm"][name])
            scaled = np.abs(got - want).max() / (1 + np.abs(want).max())
            worst["states"] = max(worst["states"], scaled)
            if scaled_states:
                assert scaled <= tol, (name, scaled)
            else:
                close(got, want, tol)
        if "kv" in jc:
            for name in ("pool_k", "pool_v"):
                got, want = tc["kv"][name], jc["kv"][name]
                if got.dtype == torch.bfloat16:
                    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2 ** -7, atol=1e-5)
                else:
                    close(got, want, tol)
            for name in ("tables", "page_pos"):
                np.testing.assert_array_equal(tc["kv"][name].numpy(), np.asarray(jc["kv"][name]))
        np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))

    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, None))
    jdecode = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t, None))
    jl, jc = jprefill(jp, jnp.asarray(tokens, jnp.int32))
    tl, tc = tmodel.prefill(tp, torch.from_numpy(tokens))
    held(tl, tc, jl, jc)
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, 2)
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt, jnp.int32))
        tl, tc = tmodel.decode_step(tp, tc, torch.from_numpy(nxt))
        held(tl, tc, jl, jc)
    return worst


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_smoke_prefill_and_decode_match_jax(arch):
    check_smoke(arch, 1e-4, kv_cache_dtype="float32")


def test_zamba2_bf16_pools_match_jax_pallas(monkeypatch):
    """bf16 pools: JAX's shared attention block on its Pallas kernels in
    interpret mode."""
    _pallas_interpret(monkeypatch)
    check_smoke("zamba2-2.7b", 2e-3)


def test_mamba2_bf16_compute_matches_jax():
    """Measured: logits within 9.7e-3 (max |logit| about 0.6); states
    within 1.0e-2 over 1 + max |state| (the conv tail 0.047 at values up to
    3.8, three bf16 steps; the SSM state 3.4e-3)."""
    worst = check_smoke("mamba2-370m", 2e-2, scaled_states=True, compute_dtype="bfloat16")
    assert worst["logits"] > 1e-3  # bf16 compute really ran


# ------------------------------ continuation ------------------------------
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_decode_matches_prefill_continuation(arch):
    """Teacher-forced decode after a prefill of 24 tokens (SSD chunks of
    12) must reach a 32-token prefill's logits and SSM states (chunks of
    16); test_arch_smoke.py's check, on the port alone."""
    cfg = get_config(arch).smoke()
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 32)))
    want, wcache = model.prefill(params, tokens)
    logits, cache = model.prefill(params, tokens[:, :24])
    for i in range(24, 32):
        logits, cache = model.decode_step(params, cache, tokens[:, i])
    close(logits, want, 2e-2)
    for name in ("ssm", "conv"):
        close(cache["ssm"][name], wcache["ssm"][name], 2e-2)
    np.testing.assert_array_equal(cache["lengths"].numpy(), [32, 32])


# ------------------------------ weights ------------------------------
def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_params_from_jax_round_trip(arch, param_dtype):
    """Every leaf crosses bit for bit with its shape and dtype (A_log, D and
    dt_bias f32 whatever param_dtype is); the port's own init has the same
    tree, shapes and dtypes; serving_params and init(dtype=bf16) keep the
    f32 leaves in f32."""
    _, tcfg = configs(arch, param_dtype=param_dtype)
    pnp = jax_params(arch, param_dtype)
    tp = params_from_jax(pnp, tcfg, device="cpu")
    flat_j = dict(_flat(pnp))
    flat_t = dict(_flat(tp))
    assert flat_t.keys() == flat_j.keys()
    for path, leaf in flat_j.items():
        t = flat_t[path]
        assert t.dtype == getattr(torch, leaf.dtype.name), path
        assert tuple(t.shape) == leaf.shape, path
        back = t.view(torch.int16).numpy().view(leaf.dtype) if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(back, leaf)
        if path[-1] in F32_LEAVES:
            assert t.dtype == torch.float32, path
    if arch.startswith("zamba2"):
        n_groups = tcfg.n_layers // tcfg.attn_every
        assert tuple(tp["mamba"]["ssm"]["in_proj"].shape[:2]) == (n_groups, tcfg.attn_every)
        assert tuple(tp["shared_attn"]["attn"]["wq"].shape) == (tcfg.d_model, tcfg.n_heads, tcfg.head_dim)
    model = build_model(tcfg)
    init = model.init(seed=0, device="cpu")
    sig = lambda tree: [(p, tuple(x.shape), x.dtype) for p, x in _flat(tree)]  # noqa: E731
    assert sig(init) == sig(tp)

    served = serving_params(tp, dataclasses.replace(tcfg, compute_dtype="bfloat16"))
    half = model.init(seed=0, device="cpu", dtype=torch.bfloat16)
    for tree in (served, half):
        for path, t in _flat(tree):
            if path[0] == "embed":
                continue
            want = torch.float32 if path[-1] in F32_LEAVES + ("norm",) else torch.bfloat16
            assert t.dtype == want, path
    for (path, h), (_, f) in zip(_flat(half), _flat(init)):
        torch.testing.assert_close(h, f.to(h.dtype), rtol=0, atol=0)
