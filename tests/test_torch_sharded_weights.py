"""Serving with the weights in the JAX package's layout: the port's
``prefill``/``decode_step`` with every leaf held as its ``param_shardings``
block, against the JAX package's jitted sharded calls.

Four ranks (spawned processes over gloo on the CPU, 60 s deadline) on a
``(data 2, model 2)`` mesh run every family at smoke size, and on a
``(data 1, model 4)`` mesh over the same ranks llama, whose 2 kv heads
then stay whole while its 4 q heads split (the rank slices the kv head its
q head reads). Both packages take the same weights, drawn once by the
port's ``init`` from seed 0 and handed over as numpy; each rank cuts its
blocks (``params_from_jax(..., layout="jax")``) and prefills its block
of the 4 rows of 64 tokens and takes three teacher-forced decode steps on
the striped cache the prefill returns. The JAX side runs in three subprocesses
with 4 forced host devices on a mesh of ``AxisType.Auto`` axes: ``prefill``
jitted with ``in_shardings`` from ``param_shardings`` and
``batch_shardings``, its cache put onto ``cache_shardings``, ``decode_step``
jitted likewise. Held:

* the logits: each rank's rows of the prefill's, and the decode steps',
  within 1e-4 with f32 pools and 2e-3 with int8 ones
  (``tests/test_torch_sharded_decode.py``'s tolerances; JAX's int8 decode
  on its Pallas kernels in interpret mode, as there);
* the replicas: bit-equal across the ranks that hold the same rows;
* the argument bytes a rank: a prefill's (its param blocks and its rows of
  the batch) equal to ``memory_analysis().argument_size_in_bytes`` of the
  JAX prefill, to the byte; a decode step's equal too, but for differences
  stated exactly (the port keeps the decode tokens replicated, and
  ``jax.jit`` drops the arguments the encoder-decoder's decode never reads);
* the SSM states (mamba2, zamba2): each rank's ``ssm`` and ``conv`` after
  the prefill and after the decode steps are its rows alone, in shape JAX's
  device shard of them under ``cache_shardings`` and in value within the
  family's tolerance of it (``addressable_shards``); with 3 rows, which do
  not divide over ``data``, every rank holds every row's states, and its
  logits and states are the unsharded model's within the tolerance;
* ``model.init(axis_info=)`` bit-equal to the blocks of the unsharded init;
* the prefill's pools: this rank's stripes of the unsharded prefill's,
  where a data shard's pages line up with its model ranks' stripes and
  where they do not;
* what decode moves: on a fake (2, 2) group one decode step's all-reduce
  bytes are a hand count of the activations (and the norm scales,
  regathered at use), with no weight among them: llama's, and mamba2's
  with the regather of each Mamba2 layer's gated output over ``data``.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import cost, dryrun  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch.mesh import make_axis_info, make_mesh  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
DEADLINE_S = 60.0
N_STEPS = 3
ROWS, SEQ, S_ENC = 4, 64, 32  # S_ENC: the Pallas flash wrapper wants Sq % min(128, Sq) == 0
ODD_ROWS = 3  # a batch that does not divide over data: every rank keeps every row's SSM states
STATE_CASES = ("hybrid", "ssm")
F32 = {"kv_cache_dtype": "float32"}
# name: (arch, overrides, tolerance, input kind)
CASES = {
    "dense": ("llama3_2-1b", F32, 1e-4, "tokens"),
    "moe": ("mixtral-8x7b", F32, 1e-4, "tokens"),
    "vlm": ("chameleon-34b", F32, 1e-4, "embeds"),
    "hybrid": ("zamba2-2.7b", F32, 1e-4, "tokens"),
    "encdec": ("seamless-m4t-medium", F32, 1e-4, "encdec"),
    "int8": ("mistral-large-123b", {}, 2e-3, "tokens"),
    "ssm": ("mamba2-370m", {}, 1e-4, "tokens"),
}
MESHES = {"2x2": ((2, 2), sorted(CASES)), "1x4": ((1, 4), ["dense"])}
# the JAX side's jobs, split over three subprocesses of about the same time
JAX_PARTS = ([("2x2", "dense"), ("1x4", "dense"), ("2x2", "vlm")],
             [("2x2", n) for n in ("encdec", "int8")],
             [("2x2", n) for n in ("hybrid", "moe", "ssm")])


def smoke(name):
    arch, overrides, *_ = CASES[name]
    return dataclasses.replace(get_config(arch).smoke(), **overrides)


def make_inputs(name):
    """The batch (numpy, the JAX batch dict's leaves) and the teacher-forced tokens."""
    cfg = smoke(name)
    kind = CASES[name][3]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if kind == "embeds":
        batch = {"embeds": rng.standard_normal((ROWS, SEQ, cfg.d_model), dtype=np.float32)}
    elif kind == "encdec":
        batch = {"enc_embeds": rng.standard_normal((ROWS, S_ENC, cfg.d_model), dtype=np.float32),
                 "tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ), dtype=np.int32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ), dtype=np.int32)}
    return batch, rng.integers(0, cfg.vocab_size, (N_STEPS, ROWS), dtype=np.int32)


def port_inputs(name, batch):
    """The batch as the port's ``prefill`` takes it."""
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    return t if CASES[name][3] == "encdec" else next(iter(t.values()))


# ------------------------------ the JAX package, in a subprocess ------------------------------
def _numpy_params(name):
    """The weights both packages take: the port's init from seed 0, as numpy."""
    return shd._map(lambda _, t: t.numpy(), build_model(smoke(name)).init(0, "cpu"))


def _jax_sharded(params_path: str, out_path: str, part: int) -> None:
    """The sharded prefill and decode logits, and argument bytes a device,
    of the jobs of ``JAX_PARTS[part]`` on 4 forced host devices; pickled as
    numpy."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config as jget
    from repro.kernels import ops as jops
    from repro.launch.dryrun import abstract_init
    from repro.models.lm import build_model as jbuild
    from repro.parallel import sharding as jshd
    from repro.parallel.axisinfo import AxisInfo

    def interpreted(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            return fn(*args, **{**kw, "impl": "pallas", "interpret": True})
        return wrapped

    plain = {n: getattr(jops, n) for n in ("flash_attention", "paged_attention")}
    with open(params_path, "rb") as fh:
        params_np = pickle.load(fh)
    out = {}
    for mesh_name, name in JAX_PARTS[part]:
        mesh = jax.make_mesh(MESHES[mesh_name][0], ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
        ai = AxisInfo(mesh, batch_axes=("data",), model_axis="model")
        arch, overrides, *_ = CASES[name]
        for n, fn in plain.items():
            setattr(jops, n, interpreted(fn) if arch == "mistral-large-123b" else fn)
        cfg = dataclasses.replace(jget(arch).smoke(), **overrides)
        model = jbuild(cfg)
        params = jax.tree.map(jnp.asarray, params_np[name])
        p_shard = jshd.param_shardings(params, abstract_init(model, jax.random.PRNGKey(0))[1], cfg, ai)
        batch_np, tokens = make_inputs(name)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        prefill = jax.jit(lambda p, b, m=model: m.prefill(p, b, ai),
                          in_shardings=(p_shard, jshd.batch_shardings(batch, cfg, ai)))
        with mesh:
            compiled = prefill.lower(params, batch).compile()
            logits, cache = compiled(params, batch)
        for key in ("kv", "self_kv", "cross_kv"):
            if key in cache:
                kv = dict(cache[key])
                pad = -kv["pool_k"].shape[1] % ai.n_page_shards
                for leaf in shd.POOL_LEAVES:
                    if leaf in kv:
                        kv[leaf] = jnp.pad(kv[leaf], [(0, 0), (0, pad)] + [(0, 0)] * (kv[leaf].ndim - 2))
                cache = dict(cache, **{key: kv})
        c_shard = jshd.cache_shardings(jax.eval_shape(lambda c=cache: c), cfg, ai)
        cache = jax.tree.map(lambda x, s: jax.device_put(x, s), cache, c_shard)
        tok = jnp.asarray(tokens[0])
        decode = jax.jit(lambda p, c, t, m=model: m.decode_step(p, c, t, ai),
                         in_shardings=(p_shard, c_shard, jshd.batch_shardings(tok, cfg, ai)),
                         out_shardings=(None, c_shard))
        states = {"prefill": _state_shards(cache)} if name in STATE_CASES else {}
        steps = []
        with mesh:
            dcompiled = decode.lower(params, cache, tok).compile()
            for t in tokens:
                lg, cache = dcompiled(params, cache, jnp.asarray(t))
                steps.append(np.asarray(lg))
        if states:
            states["decode"] = _state_shards(cache)
        out[(mesh_name, name)] = {
            "states": states,
            "prefill": np.asarray(logits),
            "decode": np.stack(steps),
            "prefill_args": compiled.memory_analysis().argument_size_in_bytes,
            "decode_args": dcompiled.memory_analysis().argument_size_in_bytes}
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


def _state_shards(cache):
    """Each distinct device shard of the cache's SSM states: ``{leaf:
    {(first row, end row): array}}`` (the model axis holds copies)."""
    out = {}
    for leaf in ("ssm", "conv"):
        arr = cache["ssm"][leaf]
        out[leaf] = {tuple(s.index[1].indices(arr.shape[1])[:2]): np.asarray(s.data) for s in arr.addressable_shards}
    return out


# ------------------------------ the port, on 4 ranks ------------------------------
def _serve_rank(ai, chosen, params_in):
    """Every case of each mesh on this rank: the (2, 2) mesh it was spawned
    on, then a (1, 4) mesh over the same ranks."""
    out = {}
    for mesh_name, (shape, names) in MESHES.items():
        if shape != (2, 2):
            ai = make_axis_info(make_mesh(shape, ("data", "model")))
        out[mesh_name] = _serve_cases(ai, params_in, names)
    return out


def _serve_cases(ai, params_in, names):
    out = {}
    rows = shd.batch_shardings({"x": (ROWS,)}, None, ai)["x"]
    for name in names:
        cfg = smoke(name)
        model = build_model(cfg)
        local = params_from_jax(params_in[name], cfg, "cpu", axis_info=ai, layout="jax")
        batch, tokens = make_inputs(name)
        held_rows = {k: shd.shard_leaf(torch.from_numpy(v), rows, ai).clone() for k, v in batch.items()}
        logits, cache = model.prefill(local, port_inputs(name, batch), axis_info=ai)
        decode_args = cost.storage_bytes((local, cache)) + tokens[0].nbytes
        states = {"prefill": {k: v.clone() for k, v in cache.get("ssm", {}).items()}}
        steps = []
        for t in tokens:
            lg, cache = model.decode_step(local, cache, torch.from_numpy(t), axis_info=ai)
            steps.append(lg)
        states["decode"] = cache.get("ssm", {})
        init = model.init(0, "cpu", axis_info=ai)
        want = shd.shard_params(model.init(0, "cpu"), cfg, ai, layout="jax")
        same = shd._map(lambda _, a, b: a.shape == b.shape and torch.equal(a, b), init, want)
        layouts = None  # the prefill's stripes against shard_cache of the unsharded prefill
        if name == "dense":
            layouts = _layouts(model, cfg, local, params_from_jax(params_in[name], cfg, "cpu"), batch, ai)
        out[name] = {"prefill": logits, "decode": torch.stack(steps),
                     "prefill_args": cost.storage_bytes(local) + cost.storage_bytes(held_rows), "decode_args": decode_args,
                     "states": states, "init_equal": same, "layouts": layouts,
                     "odd": _odd_rows(model, local, params_from_jax(params_in[name], cfg, "cpu"), batch, tokens, ai)
                     if name in STATE_CASES else None,
                     "unread": cost.storage_bytes([local["encoder"], local["ln_enc"], local["decoder"]["cross"]["wk"],
                                            local["decoder"]["cross"]["wv"]]) if "encoder" in local else 0}
    return out


def _odd_rows(model, local, full, batch, tokens, ai):
    """The prefill and decode steps of ``ODD_ROWS`` rows, sharded and
    unsharded (one rank of a (1, 1) mesh: the distributed cache rule, no
    headroom page, as the sharded prefill): (logits, final states) each."""
    from repro_torch.parallel.axisinfo import AxisInfo, Mesh

    one = AxisInfo(Mesh((1, 1), ("data", "model")), ("data",))
    x = torch.from_numpy(batch["tokens"][:ODD_ROWS])
    out = {}
    for key, params, axis_info in (("sharded", local, ai), ("unsharded", full, one)):
        logits, cache = model.prefill(params, x, axis_info=axis_info)
        steps = [logits]
        for t in tokens:
            lg, cache = model.decode_step(params, cache, torch.from_numpy(t[:ODD_ROWS]), axis_info=axis_info)
            steps.append(lg)
        out[key] = (torch.stack(steps), cache["ssm"])
    return out


def _layouts(model, cfg, local, full, batch, ai):
    """For the rows and pages that line up with the stripes (4 rows of 8
    pages) and for some that do not (2 rows of 1 page: the rows are
    regathered first): the sharded prefill's cache against
    ``shard_cache`` of the unsharded prefill with the distributed cache
    rule (no headroom page): (shapes equal, max |d|) a leaf."""
    from repro_torch.parallel.axisinfo import AxisInfo, Mesh

    one = AxisInfo(Mesh((1, 1), ("data", "model")), ("data",))
    out = {}
    for rows, seq in ((ROWS, SEQ), (2, cfg.kv_page_tokens)):
        x = torch.from_numpy(batch["tokens"][:rows, :seq])
        got = model.prefill(local, x, axis_info=ai)[1]["kv"]
        want = shd.shard_cache(model.prefill(full, x, axis_info=one)[1], cfg, ai)["kv"]
        out[rows, seq] = {k: (got[k].shape == want[k].shape, float((got[k].float() - want[k].float()).abs().max()))
                          for k in want}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_weights")
    params_in = {name: _numpy_params(name) for name in CASES}
    with open(tmp / "params.pkl", "wb") as fh:
        pickle.dump(params_in, fh)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import test_torch_sharded_weights as t; "
                               f"t._jax_sharded({str(tmp / 'params.pkl')!r}, {str(tmp / f'{i}.pkl')!r}, {i})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(len(JAX_PARTS))]
    try:
        res = launch_mesh.spawn(_serve_rank, 4, (params_in,), model_parallel=2, device="cpu", timeout_s=DEADLINE_S)
        for proc in procs:
            log, _ = proc.communicate(timeout=DEADLINE_S)
            assert proc.returncode == 0, log[-4000:]
    finally:
        for proc in procs:
            proc.kill()
    jax_out = {}
    for i in range(len(JAX_PARTS)):
        with open(tmp / f"{i}.pkl", "rb") as fh:
            jax_out.update(pickle.load(fh))
    return jax_out, {m: [r[m] for r in res] for m in MESHES}


def _cases():
    return [(m, n) for m, (_, names) in MESHES.items() for n in names]


def _rows_of(rank: int, mesh_name: str) -> slice:
    shape = MESHES[mesh_name][0]
    b = ROWS // shape[0]
    d = rank // shape[1]
    return slice(d * b, (d + 1) * b)


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("mesh_name,name", _cases())
def test_prefill_and_decode_match_jax_sharded(mesh_name, name, runs):
    """Each rank's rows of the prefill logits and every decode step's logits
    within the family's tolerance of the JAX package's sharded calls; bit
    for bit the same on every rank that holds the same rows."""
    jax_out, ranks = runs
    want, tol = jax_out[(mesh_name, name)], CASES[name][2]
    tp = MESHES[mesh_name][0][1]
    for r, res in enumerate(ranks[mesh_name]):
        got = res[name]
        close(got["prefill"], want["prefill"][_rows_of(r, mesh_name)], tol)
        close(got["decode"], want["decode"], tol)
        assert torch.equal(got["decode"], ranks[mesh_name][0][name]["decode"])
        assert torch.equal(got["prefill"], ranks[mesh_name][r - r % tp][name]["prefill"])


@pytest.mark.parametrize("mesh_name,name", _cases())
def test_argument_bytes_a_rank_equal_jax(mesh_name, name, runs):
    """A prefill holds what JAX's holds, to the byte. A decode step too (the
    SSM states its rows'), but for the tokens the port keeps replicated over
    the batch axes and the arguments ``jax.jit`` drops from an
    encoder-decoder's decode."""
    jax_out, ranks = runs
    want = jax_out[(mesh_name, name)]
    nb = MESHES[mesh_name][0][0]
    for res in ranks[mesh_name]:
        got = res[name]
        assert got["prefill_args"] == want["prefill_args"]
        replicated = ROWS * 4 * (nb - 1) // nb
        assert got["decode_args"] - replicated - got["unread"] == want["decode_args"]


@pytest.mark.parametrize("when", ["prefill", "decode"])
@pytest.mark.parametrize("name", STATE_CASES)
def test_ssm_states_are_the_ranks_rows_of_jax(name, when, runs):
    """After the sharded prefill and after the decode steps each rank holds
    the ``ssm`` and ``conv`` states of its data shard's rows alone: the
    shape of JAX's device shard of those rows under ``cache_shardings``,
    its values within the family's tolerance, bit-equal on the model
    ranks that share the rows."""
    jax_out, ranks = runs
    want, tol = jax_out[("2x2", name)]["states"][when], CASES[name][2]
    for r, res in enumerate(ranks["2x2"]):
        rows = _rows_of(r, "2x2")
        for leaf in ("ssm", "conv"):
            got = res[name]["states"][when][leaf]
            shard = want[leaf][(rows.start, rows.stop)]
            assert tuple(got.shape) == shard.shape and got.shape[1] == ROWS // 2
            close(got, shard, tol)
            assert torch.equal(got, ranks["2x2"][r - r % 2][name]["states"][when][leaf])


@pytest.mark.parametrize("name", STATE_CASES)
def test_ssm_states_stay_whole_where_the_batch_does_not_divide(name, runs):
    """3 rows over 2 data shards: every rank prefills every row and keeps
    every row's states (``cache_shardings`` gives ``P()``); its logits and
    states after the decode steps are the unsharded model's within the
    family's tolerance, bit-equal on every rank."""
    _, ranks = runs
    tol = CASES[name][2]
    first = ranks["2x2"][0][name]["odd"]["sharded"]
    for res in ranks["2x2"]:
        (logits, states), (want_logits, want_states) = res[name]["odd"]["sharded"], res[name]["odd"]["unsharded"]
        close(logits, want_logits.float().numpy(), tol)
        assert torch.equal(logits, first[0])
        for leaf in ("ssm", "conv"):
            assert states[leaf].shape == want_states[leaf].shape and states[leaf].shape[1] == ODD_ROWS
            close(states[leaf], want_states[leaf].numpy(), tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_init_is_the_blocks_of_the_unsharded_init(name, runs):
    """``init(axis_info=)``, drawn layer by layer and cut, equals the
    serving-layout blocks of the unsharded init bit for bit, on every rank."""
    _, ranks = runs
    for res in ranks["2x2"]:
        flat = []
        shd._map(lambda _, same: flat.append(same), res[name]["init_equal"])
        assert flat and all(flat)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_prefill_cache_is_the_striped_unsharded_cache(mesh_name, runs):
    """The pools a sharded prefill keeps are this rank's stripes of the
    unsharded prefill's (``shard_cache``'s blocks, padded alike), its tables
    and ``page_pos`` every row's: where a data shard's pages are its model
    ranks' stripes (4 rows of 8 pages), and where they are not (2 rows of
    one page over four stripes: the rows are regathered)."""
    _, ranks = runs
    for res in ranks[mesh_name]:
        for case, leaves in res["dense"]["layouts"].items():
            for leaf, (same_shape, err) in leaves.items():
                assert same_shape, (case, leaf)
                assert err <= (0 if leaf in ("tables", "page_pos") else 1e-5), (case, leaf, err)


def _hand_count(cfg, B: int, tp: int, nb: int) -> tuple:
    """(bytes, calls) a decode step all-reduces (f32 smoke model). A
    transformer: per layer the new token's q, k, v (every head), the
    split-K combine's (m) and (o, l), the attention and MLP outputs (every
    embed column) and the MLP's gate and hidden columns (this rank's ffn
    block); per step the embedding rows, the logits over the vocab, and the
    norm scales (regathered at use, one call). Mamba2: per layer
    ``in_proj``'s output (every column), the gated output's model block of
    every row (each data shard's rows regathered over ``data``: its states
    are that shard's) and ``out_proj``'s output (every embed column); per
    step the embedding rows, the logits, and the leaves used whole: the
    norm scales over ``data`` in one call, the conv taps and bias and the
    gated norm's scale over ``model`` in another."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    if cfg.family == "ssm":
        di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
        proj, conv_dim = 2 * di + 2 * gn + cfg.ssm_heads, di + 2 * gn
        per_layer = B * proj + B * di // tp + B * d
        per_step = B * d + B * V + (L + 1) * d + L * (cfg.ssm_conv * conv_dim + conv_dim + di)
        return 4 * (L * per_layer + per_step), 3 * L + 4
    H, K, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = B * (H + 2 * K) * hd + B * H + B * H * (hd + 1) + 2 * B * d + 2 * B * f // tp
    per_step = B * d + B * V + (2 * L + 1) * d
    return 4 * (L * per_layer + per_step), 6 * L + 3


@pytest.mark.parametrize("arch", ["llama3_2-1b", "mamba2-370m"])
def test_decode_moves_activations_only(arch):
    """A decode step on a fake (2, 2) group (llama's, and mamba2's with
    its states the rank's rows): its all-reduce bytes and calls are the
    hand count, which holds no weight's bytes."""
    cfg = get_config(arch).smoke()
    before = dict(collectives.stats)
    with dryrun.fake_world(4):
        ai = make_axis_info(make_mesh((2, 2), ("data", "model")))
        rec = dryrun.plan(cfg, "decode", ROWS, SEQ, ai)
    moved = rec["collectives"]["all-reduce"]
    nbytes, calls = _hand_count(cfg, ROWS, 2, 2)
    assert moved == nbytes == collectives.stats["bytes"] - before["bytes"]
    assert rec["collective_count"] == calls


def test_a_leaf_in_no_layout_raises_naming_it():
    """A leaf whose shape is neither whole nor this rank's block under
    ``param_shardings`` is refused by name, never taken as replicated."""
    from repro_torch.parallel.axisinfo import AxisInfo, Mesh

    cfg = smoke("dense")
    ai = AxisInfo(Mesh((2, 2), ("data", "model"), rank=3), ("data",))
    params = shd.shard_params(build_model(cfg).init(0, "cpu"), cfg, ai, layout="jax")
    assert shd.held_specs(params, cfg, ai)["blocks"]["attn"]["wq"] == shd.P(None, "data", "model")
    params["blocks"]["attn"]["wq"] = params["blocks"]["attn"]["wq"][:, :, :1]
    with pytest.raises(ValueError, match=r"params\['blocks', 'attn', 'wq'\]"):
        build_model(cfg).prefill(params, torch.zeros((4, 8), dtype=torch.int32), axis_info=ai)
