"""Port serving engine vs the JAX engine on ``get_config("llama3_2-1b").smoke()``
(and ``mixtral-8x7b``'s, for the MoE family and a sliding window) with the
same (JAX-initialised) weights: greedy tokens must be identical on the
host-allocator cases of tests/test_serving.py.

The JAX engine's default decode path (``use_pallas=False``) casts q to the
bf16 pool dtype, which its Pallas kernels and reference do not; so the
oracle here is the JAX engine with ``repro.kernels.ops.flash_attention`` and
``paged_attention`` forced onto the Pallas kernels in interpret mode
(patched in this test only)."""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.lm import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import profile_serve, serve  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("llama3_2-1b").smoke()
    tcfg = get_config("llama3_2-1b").smoke()
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Counts the patched calls (each jitted step traces them once)."""
    calls = {"flash_attention": 0, "paged_attention": 0}

    def force(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            calls[fn.__name__] += 1
            return fn(*args, **{**kw, "impl": "pallas", "interpret": True})
        return wrapped

    monkeypatch.setattr(jops, "flash_attention", force(jops.flash_attention))
    monkeypatch.setattr(jops, "paged_attention", force(jops.paged_attention))
    return calls


PAGE = [5, 7, 11, 13, 17, 19, 23, 29]  # one full page (T=8)
SYSTEM = list(range(100, 116))  # a two-page shared system prompt

# Each case is a list of "waves": the requests of a wave are submitted
# together and the engine is drained before the next wave (name, slots,
# pages, waves of (prompt, max_new_tokens)). tests/test_serving.py:38-154.
CASES = [
    ("single", 2, 64, [[(PAGE, 6)]]),
    ("concurrent_isolated", 4, 64, [[(PAGE, 5), ([2, 3, 4, 6, 8, 9, 10, 12], 5)]]),
    ("prefix_cache_shared", 4, 64, [[(PAGE + [31, 37, 41, 43, 47, 53, 59, 61], 4)],
                                    [(PAGE + [1, 2, 3, 4, 5, 6, 7, 8], 4)]]),
    ("partial_page_reuse", 4, 64, [[(PAGE + [31, 37, 41], 4), (PAGE + [31, 37, 41], 4),
                                    (PAGE + [31, 37], 4)]]),
    ("backpressure", 2, 12, [[([i + 1] * 8, 3) for i in range(5)]]),
    # the shape of chip_smoke.py's traffic, scaled down: more requests than
    # slots behind one shared system prompt (prefix sharing + batch COW forks)
    ("system_prompt", 4, 64, [[(SYSTEM + [200 + 8 * i + j for j in range(8)], 6)
                               for i in range(6)]]),
]


def run(engine_cls, request_cls, cfg, params, slots, pages, waves, **kw):
    engine = engine_cls(cfg, params, max_slots=slots, n_pages=pages, **kw)
    done, rid = {}, 0
    for wave in waves:
        for prompt, n_new in wave:
            engine.submit(request_cls(rid, list(prompt), max_new_tokens=n_new))
            rid += 1
        done.update(engine.run_until_drained())
    return engine, done


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_engine_tokens_match_jax_engine(setup, pallas_interpret, case):
    jcfg, jparams, tcfg, tparams = setup
    _, slots, pages, waves = case
    jeng, want = run(JEngine, JRequest, jcfg, jparams, slots, pages, waves)
    assert pallas_interpret["flash_attention"] > 0 and pallas_interpret["paged_attention"] > 0
    teng, got = run(ServingEngine, Request, tcfg, tparams, slots, pages, waves, device="cpu")
    assert sorted(got) == sorted(want) == list(range(sum(len(w) for w in waves)))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].prefill_skipped_tokens == want[rid].prefill_skipped_tokens, rid
    assert teng.alloc.stats == jeng.alloc.stats


@pytest.fixture(scope="module")
def moe_setup():
    jcfg = jax_get_config("mixtral-8x7b").smoke()
    tcfg = get_config("mixtral-8x7b").smoke()
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


LONG_SYSTEM = list(range(300, 340))  # five pages: longer than mixtral's 32-token smoke window

# mixtral smoke (4 experts, top 2, window 32): prompts longer than the
# window, so it cuts in every prefill and every decode row; capacity
# factor 4.0 (the smoke config's) drops no assignment
MOE_CASES = [
    ("single_long", 2, 64, [[(LONG_SYSTEM + PAGE, 8)]]),
    ("system_prompt_windowed", 4, 96, [[(LONG_SYSTEM + [200 + 8 * i + j for j in range(8)], 6)
                                        for i in range(6)]]),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_engine_tokens_match_jax_engine(moe_setup, pallas_interpret, case):
    jcfg, jparams, tcfg, tparams = moe_setup
    assert tcfg.is_moe and tcfg.sliding_window < len(LONG_SYSTEM)
    _, slots, pages, waves = case
    jeng, want = run(JEngine, JRequest, jcfg, jparams, slots, pages, waves)
    assert pallas_interpret["flash_attention"] > 0 and pallas_interpret["paged_attention"] > 0
    teng, got = run(ServingEngine, Request, tcfg, tparams, slots, pages, waves, device="cpu")
    assert sorted(got) == sorted(want) == list(range(sum(len(w) for w in waves)))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].prefill_skipped_tokens == want[rid].prefill_skipped_tokens, rid
    assert teng.alloc.stats == jeng.alloc.stats


def test_serve_launcher_moe_smoke_on_cpu(capsys):
    done = serve.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4", "--slots", "2"])
    assert len(done) == 3 and all(len(c.tokens) == 4 for c in done.values())
    assert "3 completions" in capsys.readouterr().out


def test_serve_launcher_smoke_on_cpu(capsys):
    done = serve.main(["--arch", "llama3_2-1b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4", "--slots", "2"])
    assert len(done) == 3 and all(len(c.tokens) == 4 for c in done.values())
    assert "3 completions" in capsys.readouterr().out


def test_profile_serve_rehearses_on_cpu():
    summary = profile_serve.main(["--smoke", "--device", "cpu"])
    assert summary["device"] == "cpu" and summary["tokens"] == 6 * 4
    assert summary["traced"]["device_idle_share"] is None  # no device metric from a CPU run
    assert summary["traced"]["per_decode_step"]["aten_ops"] > 0
    assert summary["untraced"]["n_decode"] == summary["traced"]["n_decode"] > 0


def test_profile_serve_device_accounting():
    """Busy time is the union of device intervals, step annotations left
    out; a decode step's share is what overlaps its host span."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def ev(name, start, end, dev=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=start, end=end))

    events = [ev("engine.decode", 0, 100), ev("k1", 10, 20), ev("k2", 15, 30), ev("k3", 50, 60),
              ev("k4", 95, 120), ev("engine.decode", 0, 100, DeviceType.CPU)]
    merged = profile_serve._merged_device_intervals(events)
    assert merged == [[10, 30], [50, 60], [95, 120]]
    assert profile_serve._overlap_us(merged, 0, 100) == 20 + 10 + 5
    assert profile_serve._decode_spans(events) == [(0, 100)]


def test_chip_smoke_capture_reproduces_engine_decode(setup):
    """chip_smoke.py's mid-run capture of a batched decode step (compact
    pool, renumbered tables, sentinel rows) gives the ref oracle the inputs
    the engine's own step saw: on the CPU both run the plain versions."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    _, _, tcfg, tparams = setup
    engine = ServingEngine(tcfg, tparams, max_slots=4, n_pages=64, device="cpu")
    profile_serve.warm_up(engine)
    captured = chip_smoke.capture_decode(engine, 4)  # wave 2: 2 live rows, 2 sentinel rows
    for r in profile_serve.cell_requests(tcfg, smoke=True):
        engine.submit(r)
    engine.run_until_drained()
    live = captured["live"]
    assert live.tolist() == [True, True, False, False]
    assert captured["cache"]["kv"]["pool_k"].shape[1] < engine.n_pool_pages
    want, _ = engine.model.decode_step(engine.params, captured["cache"], captured["tokens"], impl="ref")
    # f32 logits of the same plain computation: only summation order differs
    np.testing.assert_allclose(captured["logits"][live].numpy(), want[live].numpy(), rtol=0, atol=1e-5)


def test_default_device_entry_points_raise_without_a_card(setup, monkeypatch):
    _, _, tcfg, tparams = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tcfg).init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({}, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3_2-1b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_serve.main(["--smoke"])


def test_blob_mode_not_ported(setup):
    """Blob mode is ported (``tests/test_torch_blob_kv.py``): a ``kv_client``
    is taken, its page geometry checked against the model's. The whole
    storage core is now in ``repro_torch.core``: the ``BlobStore`` facade
    and ``flat_view``, copied for the sky application, and the federation
    and chaos harness (``tests/test_torch_federation.py``,
    ``tests/test_torch_faults.py``)."""
    _, _, tcfg, tparams = setup
    from types import SimpleNamespace

    import repro_torch.core

    wrong = SimpleNamespace(store=SimpleNamespace(page_tokens=tcfg.kv_page_tokens + 1, n_pages=64))
    with pytest.raises(ValueError, match="page_tokens"):
        ServingEngine(tcfg, tparams, device="cpu", kv_client=wrong)
    right = SimpleNamespace(store=SimpleNamespace(page_tokens=tcfg.kv_page_tokens, n_pages=16))
    engine = ServingEngine(tcfg, tparams, device="cpu", kv_client=right)
    assert engine.alloc is None and engine.pool_k.shape[1] == 16
    for name in ("Federation", "GcEpochCoordinator", "FaultInjector", "FaultSchedule", "FaultEvent"):
        assert hasattr(repro_torch.core, name) and name in repro_torch.core.__all__
    for name in ("BlobStore", "FlatView", "ZERO_PAGE", "flatten"):
        assert hasattr(repro_torch.core, name)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_engine_refuses_the_state_space_families(arch):
    """Neither engine serves ssm or hybrid: the JAX engine's decode cache
    carries no SSM state. The port says so at construction; the families
    are served through the model API."""
    cfg = get_config(arch).smoke()
    params = build_model(cfg).init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="SSM state"):
        ServingEngine(cfg, params, device="cpu")


def test_engine_pools_one_layer_per_attention_layer_and_int8_as_bf16():
    """Pools are sized by attention layers, as the JAX engine sizes them
    (zamba2-2.7b: 9 of its 54 layers). An int8-KV config (mistral-large)
    gets bf16 engine pools, as in the JAX engine, holding the prefill's K/V
    unquantized: its tokens are those of the same model with bf16 KV."""
    from types import SimpleNamespace

    for arch in ("zamba2-2.7b", "llama3_2-1b", "mixtral-8x7b"):
        n = ServingEngine._n_attn_layers(SimpleNamespace(cfg=get_config(arch)))
        assert n == JEngine._n_attn_layers(SimpleNamespace(cfg=jax_get_config(arch)))
    assert ServingEngine._n_attn_layers(SimpleNamespace(cfg=get_config("zamba2-2.7b"))) == 9
    cfg = get_config("mistral-large-123b").smoke()
    assert cfg.kv_cache_dtype == "int8"
    params = build_model(cfg).init(seed=0, device="cpu")
    prompts = [list(range(1, 12)), list(range(40, 60))]
    tokens = {}
    for kv in ("int8", "bfloat16"):
        engine = ServingEngine(dataclasses.replace(cfg, kv_cache_dtype=kv), params, max_slots=2, n_pages=16,
                               device="cpu")
        assert engine.pool_k.dtype == engine.pool_v.dtype == torch.bfloat16
        assert engine.pool_k.shape == (cfg.n_layers, 16, cfg.kv_page_tokens, cfg.n_kv_heads, cfg.head_dim)
        for i, p in enumerate(prompts):
            engine.submit(Request(i, p, max_new_tokens=6))
        done = engine.run_until_drained()
        tokens[kv] = [done[i].tokens for i in range(len(prompts))]
    assert tokens["int8"] == tokens["bfloat16"]
