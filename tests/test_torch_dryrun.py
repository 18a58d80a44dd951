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
The JAX package's layout on a fake 2 x 2 group (B=4, S=64): a prefill's,
a decode step's and a train step's argument bytes are JAX's per device
(its jitted calls with ``in_shardings`` from ``param_shardings``, compiled
in a subprocess with 4 forced host devices; the train step's its shards'
bytes), a decode step's and a train step's but for the differences the
port keeps on purpose, stated exactly;
and a prefill repeats no other rank's matmuls (its ``useful_flops_ratio``
at least 0.9).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

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
TESTS = Path(__file__).resolve().parent


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
    """Rank 0 of (data 2, model 2) trains in the JAX package's layout on
    half the global batch, its heads, ffn and vocab a model rank's half:
    its FLOPs times the four ranks are the unsharded step's. Its
    all-reduces are the hand count below, as ``collectives.stats`` counts
    them."""
    cfg = get_config("llama3_2-1b").smoke()
    whole = dryrun.plan(cfg, "train", 4, S)
    before = dict(collectives.stats)
    with dryrun.fake_world(4):
        ai = make_axis_info(make_mesh((2, 2), ("data", "model")))
        rec = dryrun.plan(cfg, "train", 4, S, ai)
    assert rec["hlo_flops_per_device"] * ai.mesh.size == whole["hlo_flops_per_device"]
    assert rec["collectives"]["all-reduce"] == _train_all_reduce_bytes(cfg, 4, S) > 0
    assert rec["collectives"]["all-reduce"] == collectives.stats["bytes"] - before["bytes"]
    assert rec["collective_count"] == collectives.stats["calls"] - before["calls"]
    assert whole["collective_count"] == 0 and rec["roofline"]["collective_s"] > 0


def _train_all_reduce_bytes(cfg, rows: int, seq: int) -> int:
    """The all-reduce bytes of a dense f32 train step on (data 2, model 2)
    in the JAX layout, counted by hand: in each microbatch (one row a data
    shard) the embedding's rows summed over ``model``; each layer's
    ``data`` blocks gathered (a zero-filled buffer of both blocks) and
    their gradients summed in the backward; the attention's and the MLP's
    outputs summed over ``model`` in the forward and their inputs'
    cotangents in the backward; ``ln_f`` gathered and its gradient summed;
    the unembedding's input cotangent summed; the vocab-parallel
    cross-entropy's largest logit a token maximised over ``model``, and its
    three floats a token gathered from both model ranks. Before them the
    count of valid labels in each data shard's rows of each microbatch
    (one float each, one all-reduce: the step takes the rank's rows
    alone). Then the table's gradient over ``data`` (every other leaf is
    a block over ``data``, reduce-scattered already), the four metrics,
    and three partial norms (the leaves split over ``data``, ``model`` and
    both)."""
    d, f, H, K, hd, V = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.padded_vocab
    A = 2  # n_microbatches(rows, grad_accum 4, 2 shards)
    T = rows // A // 2 * seq  # a rank's tokens a microbatch
    layer = 2 * (d // 2) + (d // 2) * (H // 2 + 2 * (K // 2)) * hd + (H // 2) * hd * (d // 2) + 3 * (d // 2) * (f // 2)
    per_micro = T * d + cfg.n_layers * (2 * 2 * layer + 4 * T * d) + 2 * d + T * d + T + 2 * 3 * T
    return 4 * (A * 2 + A * per_micro + (V // 2) * d + 4 + 3)


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
    # the serving layout moves activations only. A layer: q summed over data and
    # regathered over model (bf16); k and v summed over data (their 8 heads do not
    # divide the 16-way model axis, so they stay whole); the split-K combine's pmax
    # of (B, H) and psum of (B, H, hd + 1) (f32); the attention and MLP outputs
    # (B, d) and the MLP's gate and hidden columns (B, f/16) (bf16). A step: the
    # embedding rows and the logits (f32) and the norm scales, regathered at use (f32)
    B, H, K, hd, d, f, L = 128, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff, cfg.n_layers
    layer = 2 * B * (H + 2 * K) * hd + 4 * B * H * (1 + hd + 1) + 2 * 2 * B * d + 2 * 2 * B * f // 16
    step = 4 * B * d + 4 * B * cfg.padded_vocab + 4 * (2 * L + 1) * d
    assert rec["collectives"]["all-reduce"] == L * layer + step
    assert rec["collective_count"] == 7 * L + 3


def test_a_skipped_cell_is_recorded():
    rec = dryrun.run_cell("llama3_2-1b", "long_500k", False)
    assert rec["ok"] and "skipped" in rec


# ------------------------------ the serving layout on a fake 2 x 2 group ------------------------------
B4 = 4  # rows of the serving cells: two a data shard


def _jax_serving_args(out_path: str) -> None:
    """Per-device argument bytes of the JAX package's jitted prefill and
    decode step of each family (smoke, B=4, S=64) on a (data 2, model 2)
    Auto-axis mesh of 4 forced host devices: ``param_shardings``,
    ``batch_shardings`` and ``cache_shardings``, as its dry run lays them."""
    from jax.sharding import AxisType, NamedSharding, PartitionSpec

    from repro.parallel import sharding as jshd
    from repro.parallel.axisinfo import AxisInfo
    from repro.train import optimizer as jopt

    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    ai = AxisInfo(mesh, batch_axes=("data",), model_axis="model")
    out = {}
    for arch in FAMILIES:
        cfg = jax_get_config(arch).smoke()
        model = jax_build_model(cfg)
        params, axes = jdryrun.abstract_init(model, jax.random.PRNGKey(0))
        p_shard = jshd.param_shardings(params, axes, cfg, ai)
        batch = jspecs.prefill_batch_spec(cfg, B4, S)
        cache = jax.eval_shape(lambda m=model: m.init_cache(B4, S, pad_pages_to=ai.n_page_shards))
        tok = jspecs.decode_tokens_spec(cfg, B4)
        with mesh:
            prefill = jax.jit(lambda p, b, m=model: m.prefill(p, b, ai),
                              in_shardings=(p_shard, jshd.batch_shardings(batch, cfg, ai)))
            decode = jax.jit(lambda p, c, t, m=model: m.decode_step(p, c, t, ai),
                             in_shardings=(p_shard, jshd.cache_shardings(cache, cfg, ai),
                                           jshd.batch_shardings(tok, cfg, ai)))
            out[arch] = {"prefill": prefill.lower(params, batch).compile().memory_analysis().argument_size_in_bytes,
                         "decode": decode.lower(params, cache, tok).compile().memory_analysis().argument_size_in_bytes}
        # the train step's arguments as the JAX launcher lays them (params and moments in
        # param_shardings, the batch in batch_shardings): each leaf's shard on one device
        o_shard = {"m": p_shard, "v": p_shard, "step": NamedSharding(mesh, PartitionSpec())}
        data = jspecs.train_batch_spec(cfg, B4, S)
        args = (params, jax.eval_shape(jopt.adamw_init, params), data)
        out[arch]["train"] = sum(int(np.prod(sh.shard_shape(x.shape))) * x.dtype.itemsize for x, sh in zip(
            jax.tree.leaves(args), jax.tree.leaves((p_shard, o_shard, jshd.batch_shardings(data, cfg, ai)))))
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


@pytest.fixture(scope="module")
def serving_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("serving") / "jax.pkl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(TESTS.parent / "src"), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen([sys.executable, "-c", f"import test_torch_dryrun as t; t._jax_serving_args({str(out)!r})"],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        recs = {}
        with dryrun.fake_world(4):
            ai = make_axis_info(make_mesh((2, 2), ("data", "model")))
            for arch in FAMILIES + ["chameleon-34b"]:
                cfg = get_config(arch).smoke()
                if cfg.is_moe:  # capacity for exactly the routed tokens: no slot left empty
                    cfg = dataclasses.replace(cfg, capacity_factor=1.0)
                for kind in ("prefill", "decode"):
                    recs[arch, kind] = dryrun.plan(cfg, kind, B4, S, ai)
                recs[arch, "train"] = dryrun.arguments(cfg, "train", B4, S, ai)
        log, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, log[-4000:]
    with open(out, "rb") as fh:
        return recs, pickle.load(fh)


def _block_numels(cfg):
    """Elements of each leaf's block under the serving layout on (2, 2)."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.axisinfo import AxisInfo, Mesh

    ai = AxisInfo(Mesh((2, 2), ("data", "model")), ("data",))
    return shd._map(lambda _, shape, spec: int(np.prod(shape)) // 2 ** sum(e is not None for e in spec),
                    param_shapes(cfg), shd.jax_specs(cfg, ai))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_argument_bytes_a_rank_equal_jax(arch, serving_cells):
    """The train step in the JAX package's layout: the params and both
    AdamW moments a rank holds are JAX's per device, to the byte (each
    leaf's shard under ``param_shardings``, as the JAX launcher lays them,
    ``NamedSharding.shard_shape``), and so is its batch: its data shard's
    rows alone, as a JAX device holds them under ``batch_shardings``."""
    recs, jax_args = serving_cells
    assert recs[arch, "train"] == jax_args[arch]["train"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_argument_bytes_a_rank_equal_jax(arch, kind, serving_cells):
    """A prefill holds JAX's arguments to the byte (its param blocks and its
    rows of the batch: llama's are 214,656 bytes). A decode step holds
    JAX's (the SSM states its rows') plus what the port keeps replicated
    over the two batch shards on purpose (the tokens) and less the
    arguments ``jax.jit`` drops from an encoder-decoder's decode, which
    never reads them (the encoder, its norm and the cross K/V projections:
    their blocks, a quarter of each, but the norm's half)."""
    recs, jax_args = serving_cells
    cfg = get_config(arch).smoke()
    got = recs[arch, kind]["bytes_per_device"]["arguments"]
    if kind == "prefill":
        assert got == jax_args[arch]["prefill"]
        if arch == "llama3_2-1b":
            assert got == 214_656
        return
    replicated = B4 * 4 // 2
    unread = 0
    if cfg.family in ("encdec", "audio"):
        blocks = _block_numels(cfg)
        cross = blocks["decoder"]["cross"]
        unread = 4 * (_numel(blocks["encoder"]) + blocks["ln_enc"] + cross["wk"] + cross["wv"])
    assert got - replicated - unread == jax_args[arch]["decode"]


@pytest.mark.parametrize("arch", ["llama3_2-1b", "mixtral-8x7b", "chameleon-34b"])
def test_sharded_prefill_repeats_no_matmul(arch, serving_cells):
    """Dense, MoE (capacity for exactly the routed tokens) and vlm prefill:
    the ranks' matmul FLOPs add up to no more than the model's over 0.9."""
    recs, _ = serving_cells
    assert recs[arch, "prefill"]["roofline"]["useful_flops_ratio"] >= 0.9
