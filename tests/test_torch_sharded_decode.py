"""Serving across ranks: the port's ``prefill``/``decode_step`` with an
``axis_info`` vs the JAX package.

Four ranks (spawned processes over gloo on the CPU, a ``(data 2, model 2)``
mesh, a 60 s deadline) run each family with paged attention (dense, MoE,
vlm, hybrid, encoder-decoder with its read-only cross pools, int8 KV) and
the SSM family at smoke size: the weights are the JAX package's
(``params_from_jax(..., axis_info=)``: each rank keeps its experts), the
prefill is single-device (as ``tests/test_grad_compress.py``'s
``test_distributed_decode_paged_pool_sharded``), its pools padded to the
page shards and striped and its SSM states cut to the rank's rows
(``shard_cache``), then three decode steps with the
same teacher-forced tokens. Held to:

* the JAX single-device ``decode_step`` (every family), and, for llama, the
  JAX ``shard_map`` decode on a ``(2, 2)`` mesh of forced host devices, run
  in a subprocess (the devices must be forced before JAX is imported);
* each other across ranks, bit for bit (after the all-reduce the rest of a
  step is the same arithmetic on the same values), with ``page_pos`` the
  same on every rank and equal to JAX's.

Tolerances: f32 pools 1e-4, as the single-device port tests (the same
products summed in another order; the split-K combine adds f32 rounding
of the same size); int8 pools 2e-3 against JAX on its Pallas kernels in
interpret mode (the pools are read dequantized to bf16, as in
``tests/test_torch_model.py``). ``prefill`` with an ``axis_info`` (each
rank its block of the rows, the MoE split over the ranks, the pools this
rank's stripe without a headroom page) is held to its rows of JAX's
prefill logits.
``moe_ffn`` over 2 ranks (EP, and per-expert ffn TP with 3 experts) is
held to JAX's single-device layer: 1e-5 in f32, 2e-2 in bf16 (each rank
rounds its partial output to bf16 before the sum, as the JAX package's
``shard_map`` body does: ``tests/test_torch_moe.py``'s tolerances).
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
DEADLINE_S = 60.0
N_STEPS = 3
F32 = {"kv_cache_dtype": "float32"}
# family: (arch, overrides, tolerance, rows, prompt pages, input kind)
CASES = {
    "dense": ("llama3_2-1b", F32, 1e-4, 4, 2, "tokens"),
    "moe": ("mixtral-8x7b", F32, 1e-4, 3, 6, "tokens"),  # window 32 < 48-token prompts; 3 rows: tokens replicated in decode
    "vlm": ("chameleon-34b", F32, 1e-4, 2, 2, "embeds"),
    "hybrid": ("zamba2-2.7b", F32, 1e-4, 2, 2, "tokens"),
    "encdec": ("seamless-m4t-medium", F32, 1e-4, 2, 2, "encdec"),
    "int8": ("mistral-large-123b", {}, 2e-3, 2, 3, "tokens"),
    "ssm": ("mamba2-370m", {}, 1e-4, 2, 2, "tokens"),
}
S_ENC = 32  # the encoder-decoder's frames: the Pallas flash wrapper wants Sq % min(128, Sq) == 0


def smoke(arch, overrides):
    return dataclasses.replace(get_config(arch).smoke(), **overrides)


def make_inputs(name):
    arch, overrides, _, rows, pages, kind = CASES[name]
    cfg = smoke(arch, overrides)
    rng = np.random.default_rng(sorted(CASES).index(name))
    S = pages * cfg.kv_page_tokens
    if kind == "embeds":
        inputs = rng.standard_normal((rows, S, cfg.d_model), dtype=np.float32)
    elif kind == "encdec":
        inputs = {"enc_embeds": rng.standard_normal((rows, S_ENC, cfg.d_model), dtype=np.float32),
                  "tokens": rng.integers(0, cfg.vocab_size, (rows, S), dtype=np.int32)}
    else:
        inputs = rng.integers(0, cfg.vocab_size, (rows, S), dtype=np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (N_STEPS, rows), dtype=np.int32)
    return inputs, tokens


def to_torch(inputs):
    if isinstance(inputs, dict):
        return {k: torch.from_numpy(v) for k, v in inputs.items()}
    return torch.from_numpy(inputs)


def _jax_model(name):
    import jax

    from repro.configs import get_config as jget
    from repro.models.lm import build_model as jbuild

    arch, overrides, *_ = CASES[name]
    jcfg = dataclasses.replace(jget(arch).smoke(), **overrides)
    model = jbuild(jcfg)
    params = jax.jit(lambda k: model.init(k)[0])(jax.random.PRNGKey(0))
    return jcfg, model, params


def _jax_batch(inputs):
    import jax.numpy as jnp

    if isinstance(inputs, dict):
        return {k: jnp.asarray(v) for k, v in inputs.items()}
    if inputs.dtype.kind == "f":
        return {"embeds": jnp.asarray(inputs)}
    return {"tokens": jnp.asarray(inputs)}


def _page_pos(cache):
    for key in ("kv", "self_kv"):
        if key in cache:
            return np.asarray(cache[key]["page_pos"])
    return None


def jax_reference(name):
    """JAX single-device prefill and teacher-forced decode logits, the final
    page_pos, and the params as numpy. int8 pools: JAX on its Pallas
    kernels in interpret mode (its XLA decode casts q to the pool dtype)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    def force(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            return fn(*args, **{**kw, "impl": "pallas", "interpret": True})
        return wrapped

    inputs, tokens = make_inputs(name)
    with pytest.MonkeyPatch.context() as mp:
        if CASES[name][0] == "mistral-large-123b":
            mp.setattr(jops, "flash_attention", force(jops.flash_attention))
            mp.setattr(jops, "paged_attention", force(jops.paged_attention))
        jcfg, model, params = _jax_model(name)
        logits, cache = jax.jit(lambda p, b: model.prefill(p, b, None))(params, _jax_batch(inputs))
        decode = jax.jit(lambda p, c, t: model.decode_step(p, c, t, None))
        steps = []
        for t in tokens:
            lg, cache = decode(params, cache, jnp.asarray(t))
            steps.append(np.asarray(lg))
    return {"params": jax.tree.map(np.asarray, params), "prefill": np.asarray(logits),
            "decode": np.stack(steps), "page_pos": _page_pos(cache), "inputs": inputs, "tokens": tokens}


def _jax_shard_map_decode(in_path: str, out_path: str) -> None:
    """llama's smoke model (f32 pools) on a (data 2, model 2) mesh: the
    single-device prefill, its pool padded to the page shards and put onto
    ``cache_shardings``, then the decode steps under ``shard_map``, as
    ``tests/test_grad_compress.py::test_distributed_decode_paged_pool_sharded``."""
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_axis_info
    from repro.parallel import sharding as jshd

    data = np.load(in_path)
    jcfg, model, params = _jax_model("dense")
    _, cache = jax.jit(lambda p, b: model.prefill(p, b, None))(params, _jax_batch(data["inputs"]))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    ai = make_axis_info(mesh)
    kv = dict(cache["kv"])
    pad = -kv["pool_k"].shape[1] % ai.n_page_shards
    for name in ("pool_k", "pool_v"):
        kv[name] = jnp.pad(kv[name], [(0, 0), (0, pad)] + [(0, 0)] * 3)
    cache = {"kv": kv, "lengths": cache["lengths"]}
    sh = jshd.cache_shardings(jax.eval_shape(lambda: cache), jcfg, ai)
    cache = jax.tree.map(lambda x, s: jax.device_put(x, s), cache, sh)
    decode = jax.jit(lambda p, c, t: model.decode_step(p, c, t, ai))
    steps = []
    with mesh:
        for t in data["tokens"]:
            lg, cache = decode(params, cache, jnp.asarray(t))
            steps.append(np.asarray(lg))
    np.save(out_path, np.stack(steps))


def _decode_rank(ai, chosen, cases):
    """Every case on this rank: the sharded prefill's logits, then the
    single-device prefill striped over the ranks and the decode steps."""
    out = {}
    for name, c in cases.items():
        arch, overrides, *_ = CASES[name]
        cfg = smoke(arch, overrides)
        model = build_model(cfg)
        full = params_from_jax(c["params"], cfg, "cpu")
        local = params_from_jax(c["params"], cfg, "cpu", axis_info=ai)
        inputs = to_torch(c["inputs"])
        prefill_logits, pcache = model.prefill(local, inputs, axis_info=ai)
        _, cache = model.prefill(full, inputs)
        sharded = shd.shard_cache(cache, cfg, ai)
        steps = []
        for t in c["tokens"]:
            lg, sharded = model.decode_step(local, sharded, torch.from_numpy(t), axis_info=ai)
            steps.append(lg)
        res = {"prefill": prefill_logits, "decode": torch.stack(steps), "lengths": sharded["lengths"]}
        for key in ("kv", "self_kv"):
            if key in sharded:
                res["page_pos"] = sharded[key]["page_pos"]
                res["pool_pages"] = sharded[key]["pool_k"].shape[1]
                res["prefill_pages"] = pcache[key]["pool_k"].shape[1]
        if name == "ssm":  # the same model without an axis_info, from the same prefill
            _, ref = model.prefill(full, inputs)
            res["unsharded"] = torch.stack([model.decode_step(full, ref, torch.from_numpy(t))[0]
                                            for t in c["tokens"]])
        out[name] = res
    return out


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    refs = {name: jax_reference(name) for name in CASES}
    tmp = tmp_path_factory.mktemp("shard_map")
    np.savez(tmp / "in.npz", inputs=refs["dense"]["inputs"], tokens=refs["dense"]["tokens"])
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    code = (f"import test_torch_sharded_decode as t; "
            f"t._jax_shard_map_decode({str(tmp / 'in.npz')!r}, {str(tmp / 'out.npy')!r})")
    done = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=DEADLINE_S)
    assert done.returncode == 0, done.stdout[-4000:] + done.stderr[-4000:]
    shard_map = np.load(tmp / "out.npy")
    cases = {name: {k: r[k] for k in ("params", "inputs", "tokens")} for name, r in refs.items()}
    ranks = launch_mesh.spawn(_decode_rank, 4, (cases,), model_parallel=2, device="cpu", timeout_s=DEADLINE_S)
    return refs, shard_map, ranks


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy() if isinstance(got, torch.Tensor) else got, want,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_decode_matches_jax(name, sharded_runs):
    """Every rank's decode logits within the family's tolerance of JAX's
    single-device decode, bit-equal across ranks; page_pos the same on
    every rank and equal to JAX's; the pools striped in four."""
    refs, _, ranks = sharded_runs
    ref, tol = refs[name], CASES[name][2]
    for r in ranks:
        got = r[name]
        close(got["decode"], ref["decode"], tol)
        assert torch.equal(got["decode"], ranks[0][name]["decode"])
        arch, overrides, _, rows, pages, _ = CASES[name]
        assert got["lengths"].tolist() == [pages * smoke(arch, overrides).kv_page_tokens + N_STEPS] * rows
        if ref["page_pos"] is not None:
            np.testing.assert_array_equal(got["page_pos"].numpy(), ref["page_pos"])
            assert torch.equal(got["page_pos"], ranks[0][name]["page_pos"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_prefill_matches_jax(name, sharded_runs):
    """``prefill`` with an axis_info (this rank's block of the rows over
    data, every row when they do not divide; a MoE's experts over model)
    gives its rows of JAX's prefill logits, and its pools are this rank's
    stripe of the prompt's pages, with no decode-headroom page."""
    refs, _, ranks = sharded_runs
    _, _, tol, rows, pages, _ = CASES[name]
    for i, r in enumerate(ranks):
        want = refs[name]["prefill"]
        if rows % 2 == 0:  # data shard i // 2 of two
            want = want[i // 2 * rows // 2:(i // 2 + 1) * rows // 2]
        close(r[name]["prefill"], want, tol)
        if "prefill_pages" in r[name]:  # the (self) pools: the prompt's pages striped in four; one more a row
            assert r[name]["prefill_pages"] == -(-rows * pages // 4)
            assert r[name]["pool_pages"] == -(-rows * (pages + 1) // 4)


def test_llama_matches_jax_shard_map_decode(sharded_runs):
    """llama's sharded decode against the JAX package's own sharded decode
    (``shard_map`` on a (2, 2) mesh), and that against its single-device
    decode (the JAX test's claim, at this tolerance)."""
    refs, shard_map, ranks = sharded_runs
    close(torch.from_numpy(shard_map), refs["dense"]["decode"], 1e-4)
    for r in ranks:
        close(r["dense"]["decode"], shard_map, 1e-4)


def test_ssm_decode_takes_an_axis_info(sharded_runs):
    """mamba2 with its states cut to each rank's rows (``shard_cache``: its
    block over ``data``), the gated output regathered before ``out_proj``:
    the same numbers, bit for bit, as without an axis_info."""
    _, _, ranks = sharded_runs
    for r in ranks:
        assert torch.equal(r["ssm"]["decode"], r["ssm"]["unsharded"])


# ------------------------------ moe_ffn over two ranks ------------------------------
MOE_CASES = {f"{layout}-{dtype}": (n_experts, dtype)
             for layout, n_experts in (("ep", 4), ("tp", 3)) for dtype in ("float32", "bfloat16")}
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _moe_rank(ai, chosen, cases):
    out = {}
    for name, (n_experts, dtype, params, x) in cases.items():
        cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke(), n_experts=n_experts, compute_dtype=dtype)
        full = {k: torch.from_numpy(v) for k, v in params.items()}
        local = shd.shard_params({"blocks": {"ffn": {k: v[None] for k, v in full.items()}}}, cfg, ai)
        local = {k: v[0] for k, v in local["blocks"]["ffn"].items()}
        got, aux = moe.moe_ffn(local, torch.from_numpy(x).to(getattr(torch, dtype)), cfg, ai)
        out[name] = {"out": got, "aux": aux, "w1": tuple(local["w1"].shape)}
    return out


@pytest.fixture(scope="module")
def moe_runs():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import moe as jmoe

    cases, refs = {}, {}
    for name, (n_experts, dtype) in MOE_CASES.items():
        jcfg = dataclasses.replace(jget("mixtral-8x7b").smoke(), n_experts=n_experts, compute_dtype=dtype)
        params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0), jcfg)[0])
        x = np.random.default_rng(1).standard_normal((2, 16, jcfg.d_model), dtype=np.float32)
        want, aux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, params), jnp.asarray(x).astype(dtype), jcfg, None)
        cases[name] = (n_experts, dtype, params, x)
        refs[name] = (np.asarray(want, np.float32), float(aux))
    ranks = launch_mesh.spawn(_moe_rank, 2, (cases,), model_parallel=2, device="cpu", timeout_s=DEADLINE_S)
    return refs, ranks


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_ffn_over_two_ranks_matches_jax(name, moe_runs):
    """Each of the 2 model ranks holds 2 of 4 experts (EP) or half of each
    of 3 experts' ffn columns (expert-TP); the summed output and the aux
    loss match JAX's single-device layer on every rank."""
    refs, ranks = moe_runs
    n_experts, dtype = MOE_CASES[name]
    want, aux = refs[name]
    d, f = 64, 128
    for r in ranks:
        got = r[name]
        assert got["w1"] == ((2, d, f) if n_experts == 4 else (3, d, f // 2))
        assert got["out"].dtype == getattr(torch, dtype)
        close(got["out"], want, MOE_TOL[dtype])
        np.testing.assert_allclose(float(got["aux"]), aux, rtol=1e-5, atol=1e-6)
        assert torch.equal(got["out"], ranks[0][name]["out"])
