"""The port's dry run (``repro_torch.launch.dryrun``, ``cost``, ``specs``)
against the JAX package's on the CPU.

The JAX side is lowered and compiled unsharded, in this process, over
``ShapeDtypeStruct`` inputs, and counted with ``hlo_cost.analyze_hlo``; the
port's side runs its own step code on fake tensors. On one smoke config a
family (B=2, S=64): prefill and decode matmul FLOPs are equal, and so are
the argument bytes (but where ``jax.jit`` drops arguments the step never
reads, named in the test); the train step's FLOPs are within 1% of the
JAX loss and gradient's (AdamW has no matmul; the SSD backward differs in a
few small matmuls). Also held: the input specs and
``concrete_batch`` draws, the counter on hand-counted calls, a sharded cell
on a fake 2 x 2 group against the unsharded one, and one full-size cell.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.models.lm import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import param_shapes  # noqa: E402
from repro_torch.launch import cost, dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_axis_info, make_mesh  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402

FAMILIES = ["llama3_2-1b", "mixtral-8x7b", "mamba2-370m", "zamba2-2.7b", "seamless-m4t-medium"]
B, S = 2, 64


def jax_cell(arch, kind, keep_unused=False):
    """(HloCost, memory analysis) of one unsharded smoke step of the JAX
    package; for ``"train"`` its loss and gradient."""
    cfg = jax_get_config(arch).smoke()
    model = jax_build_model(cfg)
    params = jax.eval_shape(lambda k: model.init(k)[0], jax.random.PRNGKey(0))
    if kind == "train":  # the loss and its gradient: AdamW adds no matmul, and compiles slowly
        fn = jax.value_and_grad(lambda p, b: model.train_loss(p, b, None)[0])
        args = (params, jspecs.train_batch_spec(cfg, B, S))
    elif kind == "prefill":
        fn = lambda p, b: model.prefill(p, b, None)  # noqa: E731
        args = (params, jspecs.prefill_batch_spec(cfg, B, S))
    else:
        fn = lambda p, c, t: model.decode_step(p, c, t, None)  # noqa: E731
        args = (params, jax.eval_shape(lambda: model.init_cache(B, S)), jspecs.decode_tokens_spec(cfg, B))
    compiled = jax.jit(fn, keep_unused=keep_unused).lower(*args).compile()
    return analyze_hlo(compiled.as_text()), compiled.memory_analysis()


# ------------------------------ specs ------------------------------
@pytest.mark.parametrize("arch", ["llama3_2-1b", "chameleon-34b", "seamless-m4t-medium"])
def test_specs_match_the_jax_specs(arch):
    """tokens, embeds and encdec inputs: the same names, shapes and dtypes,
    on the meta device."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)

    def described(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tree.items()}

    for fn in ("train_batch_spec", "prefill_batch_spec"):
        got, want = getattr(specs, fn)(cfg, 4, 128), getattr(jspecs, fn)(jcfg, 4, 128)
        assert described(got) == described(want)
        assert all(t.device.type == "meta" for t in got.values())
    tok, jtok = specs.decode_tokens_spec(cfg, 8), jspecs.decode_tokens_spec(jcfg, 8)
    assert (tuple(tok.shape), tok.dtype, tok.device.type) == (jtok.shape, torch.int32, "meta")


@pytest.mark.parametrize("arch", ["llama3_2-1b", "chameleon-34b", "seamless-m4t-medium"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_concrete_batch_draws_the_jax_numbers(arch, mode):
    """Tokens and labels equal; bf16 embeddings bit for bit."""
    cfg, jcfg = get_config(arch).smoke(), jax_get_config(arch).smoke()
    got = specs.concrete_batch(cfg, 3, 16, mode, seed=5, device="cpu")
    want = jspecs.concrete_batch(jcfg, 3, 16, mode, seed=5)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype == np.int32:
            assert got[k].dtype == torch.int32 and np.array_equal(got[k].numpy(), w)
        else:
            assert got[k].dtype == torch.bfloat16
            assert np.array_equal(got[k].view(torch.int16).numpy(), w.view(np.int16))


def test_should_skip_is_the_jax_rule():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            want = jdryrun.should_skip(jax_get_config(arch), shape.name)
            assert dryrun.should_skip(get_config(arch), shape.name) == want


# ------------------------------ FLOPs and bytes against the JAX package ------------------------------
def _numel(shapes) -> int:
    """Elements of a tree of shapes (:func:`param_shapes`)."""
    if isinstance(shapes, dict):
        return sum(_numel(v) for v in shapes.values())
    return int(np.prod(shapes))


def _unread_bytes(cfg):
    """What ``jax.jit`` drops from an encoder-decoder's decode step, which
    never reads it: the encoder's weights and final norm, and the cross
    attention's K/V projections (their output is in the cross pools)."""
    shapes = param_shapes(cfg)
    cross = shapes["decoder"]["cross"]
    n = _numel(shapes["encoder"]) + _numel(shapes["ln_enc"]) + _numel(cross["wk"]) + _numel(cross["wv"])
    return n * cfg.pdtype().itemsize


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_flops_and_argument_bytes_equal_jax(arch, kind):
    cfg = get_config(arch).smoke()
    rec = dryrun.plan(cfg, kind, B, S)
    hc, mem = jax_cell(arch, kind)
    assert rec["hlo_flops_per_device"] == hc.flops > 0
    args = rec["bytes_per_device"]["arguments"]
    if cfg.family in ("encdec", "audio") and kind == "decode":
        assert args == jax_cell(arch, kind, keep_unused=True)[1].argument_size_in_bytes
        assert args - mem.argument_size_in_bytes == _unread_bytes(cfg) > 0
    else:
        assert args == mem.argument_size_in_bytes


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_flops_within_one_percent_of_jax(arch):
    cfg = get_config(arch).smoke()
    rec = dryrun.plan(cfg, "train", B, S)
    hc, mem = jax_cell(arch, "train")
    assert abs(rec["hlo_flops_per_device"] / hc.flops - 1) < 0.01
    # the JAX side takes no AdamW state: two f32 moments and an int32 step
    opt_bytes = 2 * 4 * _numel(param_shapes(cfg)) + 4
    assert rec["bytes_per_device"]["arguments"] == mem.argument_size_in_bytes + opt_bytes


# ------------------------------ the counter on hand counts ------------------------------
def test_matmul_cost_is_its_hand_count():
    M, K, N = 24, 40, 8
    a, b = torch.ones((M, K)), torch.ones((K, N))
    out, c = cost.measure(torch.mm, a, b)
    assert c.flops == 2 * M * K * N
    assert c.bytes == (M * K + K * N + M * N) * 4
    assert c.peak_bytes == M * N * 4 and c.collective_total == 0
    assert set(c.collective_bytes) == set(cost.COLLECTIVE_OPS)


def test_a_view_costs_nothing():
    x = torch.ones((16, 16))
    _, c = cost.measure(lambda t: t.view(-1).view(16, 16).t(), x)
    _, c2 = cost.measure(lambda t: t.reshape(4, 64)[1:], x)
    assert (c.flops, c.bytes, c.peak_bytes) == (0, 0, 0) == (c2.flops, c2.bytes, c2.peak_bytes)


def test_peak_bytes_of_a_chain_of_temporaries():
    """y (2n) and z (n) live together, y is freed, then w (3n) beside z:
    the peak is 4n elements, and the bytes of each op its operands and
    result."""
    n = 1000
    x = torch.ones(n)

    def chain(x):
        y = torch.cat([x, x])
        z = y[:n] * 2
        del y
        return torch.cat([z, z, z])

    out, c = cost.measure(chain, x)
    assert out.shape == (3 * n,)
    assert c.peak_bytes == 4 * n * 4
    assert c.bytes == 4 * ((n + n + 2 * n) + (n + n) + (n + n + n + 3 * n))


# ------------------------------ a sharded cell on fake ranks ------------------------------
def test_sharded_train_cell_on_a_fake_2x2_group():
    """Rank 0 of (data 2, model 2) trains on half the global batch: its
    FLOPs times the two batch shards are the unsharded step's. Its
    all-reduces carry every f32 gradient and the four summed metrics, as
    ``collectives.stats`` counts them."""
    cfg = get_config("llama3_2-1b").smoke()
    whole = dryrun.plan(cfg, "train", 4, S)
    before = dict(collectives.stats)
    with dryrun.fake_world(4):
        ai = make_axis_info(make_mesh((2, 2), ("data", "model")))
        rec = dryrun.plan(cfg, "train", 4, S, ai)
    assert rec["hlo_flops_per_device"] * ai.n_batch_shards == whole["hlo_flops_per_device"]
    assert rec["collectives"]["all-reduce"] == 4 * _numel(param_shapes(cfg)) + 4 * 4
    assert rec["collectives"]["all-reduce"] == collectives.stats["bytes"] - before["bytes"]
    assert rec["collective_count"] == collectives.stats["calls"] - before["calls"]
    assert whole["collective_count"] == 0 and rec["roofline"]["collective_s"] > 0


# ------------------------------ full size ------------------------------
def test_full_size_decode_cell():
    t0 = time.time()
    rec = dryrun.run_cell("llama3_2-1b", "decode_32k", False)
    assert time.time() - t0 < 60
    assert rec["ok"] and rec["device"] == "fake" and rec["n_devices"] == 256, rec.get("error")
    assert set(rec["bytes_per_device"]) == {"arguments", "outputs", "temps", "total"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant", "model_flops",
                                    "useful_flops_ratio"}
    assert set(rec["collectives"]) == set(cost.COLLECTIVE_OPS)
    for key in ("hlo_flops_per_device", "hlo_bytes_per_device", "collective_count"):
        assert rec[key] > 0
    cfg = get_config("llama3_2-1b")
    assert rec["model_flops"] == 2 * cfg.param_count(active_only=True) * 128
    # a split-K combine a layer: one pmax of (B, H) and one psum of (B, H, hd + 1), f32
    assert rec["collectives"]["all-reduce"] == cfg.n_layers * 128 * cfg.n_heads * (1 + cfg.head_dim + 1) * 4


def test_a_skipped_cell_is_recorded():
    rec = dryrun.run_cell("llama3_2-1b", "long_500k", False)
    assert rec["ok"] and "skipped" in rec
