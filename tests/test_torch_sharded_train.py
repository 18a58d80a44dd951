"""Training across ranks: the port's ``make_train_step(axis_info=)`` against
the JAX package's own sharded step.

The JAX side runs in a subprocess with 4 forced host devices: the JAX
package's ``make_train_step(model, cfg, ai, opt, param_shardings=...)``,
jitted with the launcher's in and out shardings, on a ``(data 2, model 2)``
mesh built here with ``AxisType.Auto`` axes. ``repro.launch.mesh`` builds
its meshes without ``axis_types``, which jax 0.9.0 makes Explicit, and then
``with_sharding_constraint`` refuses them; with Auto axes the JAX package's
sharded path runs unchanged. ``adamw_update`` is wrapped there, in the
subprocess only, so that the step also returns the gradients it applied.

The port runs the same step on 4 spawned gloo CPU ranks of a ``(2, 2)``
mesh, each rank handed its ``batch_shardings`` block of the batch (its rows
alone, as the JAX step's ``in_shardings`` would lay them), with the JAX
package's weights, in both of its layouts: the one it
trained in first (``params_from_jax(axis_info=)``: each rank keeps its
experts, every other leaf whole) and the JAX package's own
(``layout="jax"``: every leaf its ``param_shardings`` block, FSDP over
``data``, tensor-parallel over ``model``), for the dense, moe (under full
remat, so that the collectives run again in the recomputation), ssm,
hybrid and audio families at smoke width with 2 layers, B = 8 rows of S =
16 tokens, some labels -1 (padding, unevenly over the rows, so that each
share's divisor must be the whole microbatch's count), ``grad_accum`` 4
(four microbatches of two rows, one row a data shard). The same ranks also
run llama in the JAX layout on a ``(data 4, model 1)`` mesh (pure FSDP),
against the JAX step on the same mesh shape. llama and mixtral also take
the step on the global batch, every rank holding all of it, which the
rank's-rows step equals within 1e-6 (the same rows a data shard in each
microbatch; the f32 sums in another order).

Held, each within 1e-5: the loss and metrics, every gradient leaf, the
updated params and the moments (each leaf against its block of JAX's);
each leaf bit-equal on the ranks that hold the same block; in the JAX
layout the bytes a rank holds, to the byte JAX's per device. The
launcher's rank-local ``TokenPipeline`` reads bit for bit the global
reader's block of each batch. The MoE
layer's sharded gradients (router, tokens, experts; aux weight 1, EP with 4
experts and expert-TP with 3) against ``jax.grad`` through the JAX
package's ``moe_ffn(axis_info)``, also within 1e-5. And the collectives'
autograd forms against an unsharded product's gradients, with
``gather_blocks`` over the model axis off by the axis size.
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
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
DEADLINE_S = 300.0  # a hang ends here; the driver runs several test files at once
TOL = 1e-5
B, S = 8, 16
CASES = {
    "dense": ("llama3_2-1b", {}),
    "moe": ("mixtral-8x7b", {"remat": "full"}),
    "ssm": ("mamba2-370m", {}),
    "hybrid": ("zamba2-2.7b", {}),
    "audio": ("seamless-m4t-medium", {}),
}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)
OPT_CFG = opt.AdamWConfig(**OPT)
# AdamW's first step moves each element by lr * g / (|g| + eps): where the clipped gradient
# is within a hundred eps of zero, an f32 rounding difference in g moves the update by up
# to lr, so there the updated params are held to within one lr of the old ones only
TINY_GRAD = 100 * OPT_CFG.eps
MOE_CASES = {"ep": 4, "tp": 3}  # experts: 4 divide the model axis (EP), 3 do not (expert-TP)
FSDP_CASES = ("dense",)  # on (data 4, model 1): pure FSDP
# the port's runs: (mesh, layout, cases); "experts" is the layout the port trained in first
GLOBAL_CASES = ("dense", "moe")  # also stepped on the global batch, held to the rank's-rows step
RUNS = {"experts": ((2, 2), "experts", sorted(CASES)), "jax": ((2, 2), "jax", sorted(CASES)),
        "fsdp": ((4, 1), "jax", list(FSDP_CASES)), "global": ((2, 2), "jax", list(GLOBAL_CASES))}
GLOBAL_TOL = 1e-6
AUX_W = 1.0


def smoke_overrides(name):
    return {"n_layers": 2, **CASES[name][1]}


def make_batch(name):
    cfg = dataclasses.replace(get_config(CASES[name][0]).smoke(), **smoke_overrides(name))
    rng = np.random.default_rng(sorted(CASES).index(name))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    batch["labels"][5, :11] = -1
    if cfg.family in ("encdec", "audio"):
        batch["enc_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return batch


def moe_inputs(name):
    rng = np.random.default_rng(10 + MOE_CASES[name])
    return (rng.standard_normal((B, S, 64)).astype(np.float32), rng.standard_normal((B, S, 64)).astype(np.float32))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], path + (k,)).items()}
    return {path: tree}


# ------------------------------ the JAX package, in a subprocess ------------------------------
def _jax_sharded_steps(out_path: str) -> None:
    """Every case's sharded step and the MoE layer's gradients on a (2, 2)
    Auto-axis mesh of 4 forced host devices; pickled as numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec

    import repro.train.trainer as jtrainer
    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro.models.lm import build_model as jbuild
    from repro.parallel import sharding as jshd
    from repro.parallel.axisinfo import AxisInfo
    from repro.train import optimizer as jopt

    inner = jtrainer.adamw_update

    def with_grads(params, grads, state, cfg):  # the gradients the step applies, as a metric
        params, state, metrics = inner(params, grads, state, cfg)
        return params, state, dict(metrics, grads=grads)

    jtrainer.adamw_update = with_grads

    def sharded_step(name, shape):
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
        ai = AxisInfo(mesh, batch_axes=("data",), model_axis="model")
        arch, _ = CASES[name]
        cfg = dataclasses.replace(jget(arch).smoke(), **smoke_overrides(name))
        model = jbuild(cfg)
        params = jax.jit(lambda k, m=model: m.init(k)[0])(jax.random.PRNGKey(0))
        axes = model.init(jax.random.PRNGKey(0))[1]  # names: not a jit output
        state = jopt.adamw_init(params)
        p_shard = jshd.param_shardings(params, axes, cfg, ai)
        o_shard = {"m": p_shard, "v": p_shard, "step": NamedSharding(mesh, PartitionSpec())}
        step = jtrainer.make_train_step(model, cfg, ai, jopt.AdamWConfig(**OPT), param_shardings=p_shard)
        step = jax.jit(step, in_shardings=(p_shard, o_shard, None), out_shardings=(p_shard, o_shard, None))
        batch = {k: jnp.asarray(v) for k, v in make_batch(name).items()}
        new_p, new_s, metrics = step(params, state, batch)
        # the bytes of the state one device holds (every device holds as many)
        held = sum(a.addressable_shards[0].data.nbytes for a in jax.tree.leaves((new_p, new_s)))
        return dict(jax.tree.map(np.asarray, {
            "params0": params, "params": new_p, "m": new_s["m"], "v": new_s["v"],
            "grads": metrics.pop("grads"), "metrics": metrics}), bytes=held)

    out = {"steps": {name: sharded_step(name, (2, 2)) for name in CASES},
           "fsdp": {name: sharded_step(name, (4, 1)) for name in FSDP_CASES}, "moe": {}}
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    ai = AxisInfo(mesh, batch_axes=("data",), model_axis="model")
    for name, n_experts in MOE_CASES.items():
        cfg = dataclasses.replace(jget("mixtral-8x7b").smoke(), n_experts=n_experts)
        params = jmoe.moe_init(jax.random.PRNGKey(1), cfg)[0]
        x, c = (jnp.asarray(a) for a in moe_inputs(name))

        def f(p, xx):
            o, aux = jmoe.moe_ffn(p, xx, cfg, ai)
            return jnp.sum(o * c) + AUX_W * aux

        gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)
        out["moe"][name] = jax.tree.map(np.asarray, {"params": params, "grads": gp, "x": gx})
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


# ------------------------------ the collectives' autograd forms ------------------------------
FORM_ROWS, FORM_IN, FORM_OUT = 3, 8, 6  # rows a data shard; a product's contracting and output dims


def form_inputs():
    """``x`` (the rows of both data shards), weights ``w``, ``u`` and the
    cotangent weights ``c`` of the loss ``sum(y * c)``, f32."""
    rng = np.random.default_rng(7)
    shapes = {"x": (2 * FORM_ROWS, FORM_IN), "w": (FORM_IN, FORM_OUT), "u": (FORM_IN, FORM_OUT),
              "c": (2 * FORM_ROWS, FORM_OUT)}
    return {k: rng.standard_normal(shape).astype(np.float32) for k, shape in shapes.items()}


def form_loss(form, x, w, u, c):
    """The unsharded function each form computes: the loss of the rows
    ``x`` (FSDP also squares a second product)."""
    y = x @ w + (x @ u) ** 2 if form == "fsdp" else x @ w
    return torch.sum(y * c)


def _forms(ai):
    """Each form's gradients of its rank's loss share on the (data 2,
    model 2) mesh, the rows a data shard: ``x`` whole on the model ranks;
    ``w`` a block over ``model`` on its output dim (``tp_gather``, and
    ``gather_blocks`` in its place) or on its contracting dim
    (``tp_block``), or ``w`` and ``u`` blocks over ``data`` on their rows
    (``gather_blocks_many``: FSDP)."""
    mesh = ai.mesh
    i, j = (collectives.axis_index(a, mesh) for a in ("data", "model"))
    t = {k: torch.from_numpy(v) for k, v in form_inputs().items()}
    rows = slice(i * FORM_ROWS, (i + 1) * FORM_ROWS)
    c = t["c"][rows]
    out = {}
    for form in ("tp_gather", "gather_blocks", "tp_block", "fsdp"):
        x = t["x"][rows].clone().requires_grad_(True)
        if form == "fsdp":
            ws = [block.clone().requires_grad_(True) for block in t["w"].chunk(2, 0)[i:i + 1] + t["u"].chunk(2, 0)[i:i + 1]]
            w, u = collectives.gather_blocks_many(ws, "data", mesh)
            loss = form_loss(form, x, w, u, c)
        elif form == "tp_block":
            ws = [t["w"].chunk(2, 0)[j].clone().requires_grad_(True)]
            y = collectives.tp_gather([collectives.tp_block(x, -1, "model", mesh) @ ws[0]], (), mesh, "model")[0]
            loss = torch.sum(y * c)
        else:
            ws = [t["w"].chunk(2, 1)[j].clone().requires_grad_(True)]
            part = (collectives.grad_psum("model", mesh, x) @ ws[0]).movedim(-1, 0)
            whole = (collectives.tp_gather([part], "model", mesh)[0] if form == "tp_gather" else
                     collectives.gather_blocks(part, "model", mesh))
            loss = torch.sum(whole.movedim(0, -1) * c)
        grads = torch.autograd.grad(loss, [x] + ws)
        out[form] = {"x": grads[0], "w": list(grads[1:])}
    return out


# ------------------------------ the port, on 4 ranks ------------------------------
def _train_rank(ai, chosen, steps_in, moe_in):
    """One sharded step of every case in each layout (``RUNS``), capturing
    the gradients the update applies and the bytes the rank holds; the
    MoE layer's gradient shares, summed over the data axis; the collectives'
    autograd forms (:func:`_forms`)."""
    out = {"steps": {}, "moe": {}, "forms": _forms(ai)}
    inner, inner_reduce = trainer.adamw_update, trainer.reduce_gradients
    seen = {}

    def capture(params, grads, state, cfg, gnorm=None):
        seen["grads"] = {k: v.clone() for k, v in _flat(grads).items()}
        return inner(params, grads, state, cfg, gnorm=gnorm)

    def count_reduce(grads, axis_info, held):
        calls = collectives.stats["calls"]
        inner_reduce(grads, axis_info, held)
        seen["grad_calls"] += collectives.stats["calls"] - calls

    trainer.adamw_update, trainer.reduce_gradients = capture, count_reduce
    for run, (shape, layout, names) in RUNS.items():
        run_ai = ai if shape == (2, 2) else launch_mesh.make_axis_info(launch_mesh.make_mesh(shape, ("data", "model")))
        for name in names:
            arch, _ = CASES[name]
            cfg = dataclasses.replace(get_config(arch).smoke(), **smoke_overrides(name))
            params = params_from_jax(steps_in[name], cfg, "cpu", axis_info=run_ai, layout=layout)
            state = opt.adamw_init(params)
            step = trainer.make_train_step(build_model(cfg), cfg, opt.AdamWConfig(**OPT), axis_info=run_ai,
                                           param_shardings=shd.param_specs(cfg, run_ai, layout))
            batch = {k: torch.from_numpy(v) for k, v in make_batch(name).items()}
            if run != "global":  # the rank's rows alone, as batch_shardings lays them
                batch = {k: shd.shard_leaf(v, spec, run_ai).clone() for (k, v), spec in
                         zip(batch.items(), shd.batch_shardings(batch, cfg, run_ai).values())}
            seen["grad_calls"] = 0
            params, state, metrics = step(params, state, batch, B)
            held = [t for part in (params, state) for t in _flat(part).values()]
            out["steps"][run, name] = {"params": _flat(params), "m": _flat(state["m"]), "v": _flat(state["v"]),
                                       "grads": seen["grads"], "metrics": metrics, "grad_calls": seen["grad_calls"],
                                       "bytes": sum(t.numel() * t.element_size() for t in held)}
    trainer.adamw_update, trainer.reduce_gradients = inner, inner_reduce
    mesh = ai.mesh
    i, n = collectives.axis_index("data", mesh), collectives.axis_size("data", mesh)
    for name, (jparams, x, c) in moe_in.items():
        cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke(), n_experts=MOE_CASES[name])
        local = shd.shard_params({"blocks": {"ffn": {k: v[None] for k, v in jparams.items()}}}, cfg, ai)
        local = {k: torch.from_numpy(np.ascontiguousarray(v[0])).requires_grad_(True)
                 for k, v in local["blocks"]["ffn"].items()}
        names = sorted(local)
        # the rank's data shard (training), then every token on every rank (the
        # replicated batch: each rank's share of the whole loss, its block routed)
        for routed, rows in (("local", slice(i * B // n, (i + 1) * B // n)), ("replicated", slice(0, B))):
            xs = torch.from_numpy(x[rows]).requires_grad_(True)
            o, aux = moe.moe_ffn(local, xs, cfg, ai, local_batch=routed == "local")
            if routed == "local":
                share = torch.sum(o * torch.from_numpy(c[rows])) + AUX_W * aux / n
            else:
                share = (torch.sum(o * torch.from_numpy(c[rows])) + AUX_W * aux) / n
            grads = torch.autograd.grad(share, [local[k] for k in names] + [xs])
            gx = grads[-1] if routed == "local" else collectives.psum(grads[-1], "data", mesh)
            out["moe"][f"{name}-{routed}"] = {
                "params": {k: collectives.psum(g, "data", mesh) for k, g in zip(names, grads)},
                "x": gx, "rows": (rows.start, rows.stop), "aux": aux.detach()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro.models.lm import build_model as jbuild

    tmp = tmp_path_factory.mktemp("sharded_train")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    code = f"import test_torch_sharded_train as t; t._jax_sharded_steps({str(tmp / 'jax.pkl')!r})"
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        steps_in = {}
        for name, (arch, _) in CASES.items():
            jcfg = dataclasses.replace(jget(arch).smoke(), **smoke_overrides(name))
            model = jbuild(jcfg)
            steps_in[name] = jax.tree.map(np.asarray, jax.jit(lambda k, m=model: m.init(k)[0])(jax.random.PRNGKey(0)))
        moe_in = {}
        for name, n_experts in MOE_CASES.items():
            jcfg = dataclasses.replace(jget("mixtral-8x7b").smoke(), n_experts=n_experts)
            moe_in[name] = (jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(1), jcfg)[0]),
                            *moe_inputs(name))
        ranks = launch_mesh.spawn(_train_rank, 4, (steps_in, moe_in), model_parallel=2, device="cpu",
                                  timeout_s=DEADLINE_S)
        log, _ = proc.communicate(timeout=DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-6000:]
    with open(tmp / "jax.pkl", "rb") as fh:
        ref = pickle.load(fh)
    return ref, ranks, steps_in


def close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


def _spec(name, path, ai, layout="experts"):
    """The spec of a leaf as the port holds it in ``layout``."""
    arch, _ = CASES[name]
    cfg = dataclasses.replace(get_config(arch).smoke(), **smoke_overrides(name))
    return _flat(shd.param_specs(cfg, ai, layout))[path]


def _block(flat, name, path, ai, layout="experts"):
    """JAX's leaf at ``path``, cut to the block this rank keeps in ``layout``."""
    spec = _spec(name, path, ai, layout)
    return shd.shard_leaf(flat[path], spec, ai) if len(spec) else flat[path]


def _axis_info(rank, shape=(2, 2)):
    return launch_mesh.make_axis_info(shd.Mesh(shape, ("data", "model"), rank=rank))


def _matches_jax(run, name, runs):
    """Every rank's step of ``run`` against the JAX package's (the
    docstrings of the tests below): metrics, one gradient all-reduce, and
    every leaf of the gradients, params and moments against its block."""
    ref, ranks, _ = runs
    shape, layout, _ = RUNS[run]
    want = ref["fsdp" if run == "fsdp" else "steps"][name]
    jflat = {k: _flat(want[k]) for k in ("grads", "params", "m", "v", "params0")}
    for rank, r in enumerate(ranks):
        got = r["steps"][run, name]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, v in got["metrics"].items():
            close(v, want["metrics"][k])
        assert got["grad_calls"] == 1
        ai = _axis_info(rank, shape)
        for part in ("grads", "params", "m", "v"):
            assert sorted(got[part]) == sorted(jflat[part])
            for path, t in got[part].items():
                want_t = _block(jflat[part], name, path, ai, layout)
                if part == "params":  # where the clipped gradient is tiny, within one lr (the docstring's rule)
                    tiny = np.abs(_block(jflat["m"], name, path, ai, layout)) / (1 - OPT_CFG.b1) < TINY_GRAD
                    step = np.abs(t.numpy() - _block(jflat["params0"], name, path, ai, layout))
                    assert (step[tiny] <= OPT_CFG.lr).all(), (path, rank)
                    want_t = np.where(tiny, t.numpy(), want_t)
                close(t, want_t, what=f"{part} {path} rank {rank}")


def _replicas_equal(run, name, runs):
    """Each leaf bit-equal on the ranks that hold the same block of it, the
    metrics on every rank."""
    _, ranks, _ = runs
    shape, layout, _ = RUNS[run]
    mesh = shd.Mesh(shape, ("data", "model"))
    for part in ("params", "m", "v", "grads"):
        for path in ranks[0]["steps"][run, name][part]:
            axes = [e for e in _spec(name, path, _axis_info(0, shape), layout) if e is not None]
            groups = {}
            for rank in range(mesh.size):
                groups.setdefault(tuple(mesh.axes_index((e,) if isinstance(e, str) else e, rank) for e in axes),
                                  []).append(rank)
            for group in groups.values():
                first = ranks[group[0]]["steps"][run, name][part][path]
                for rank in group[1:]:
                    assert torch.equal(ranks[rank]["steps"][run, name][part][path], first), (part, path, rank)
    for r in ranks:
        for k, v in r["steps"][run, name]["metrics"].items():
            assert torch.equal(v, ranks[0]["steps"][run, name]["metrics"][k])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_jax_sharded_step(name, runs):
    """The port's first layout (the experts split over the model axis,
    every other leaf whole): loss and metrics, every gradient leaf, the
    updated params and both moments on every rank within 1e-5 of the JAX
    package's sharded step (an expert leaf against its block; the params
    where the clipped gradient is not within ``TINY_GRAD`` of zero, and
    within one lr of the old params where it is); the gradients cross in
    one all-reduce (one bucket at smoke size)."""
    _matches_jax("experts", name, runs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_is_the_same_on_every_rank(name, runs):
    """After the step, replicated leaves are bit-equal on all four ranks
    and expert leaves across the data ranks (ranks r and r + 2 of the
    (data 2, model 2) mesh share a model coordinate); the metrics are
    equal everywhere."""
    _replicas_equal("experts", name, runs)


JAX_RUNS = [("jax", name) for name in sorted(CASES)] + [("fsdp", name) for name in FSDP_CASES]


@pytest.mark.parametrize("run,name", JAX_RUNS)
def test_jax_layout_step_matches_jax_sharded_step(run, name, runs):
    """The JAX package's layout (``param_shardings``: FSDP over ``data``,
    heads, ffn, vocab and the SSM projections over ``model``) on (data 2,
    model 2), and llama's on (data 4, model 1), pure FSDP: loss and
    metrics, every gradient leaf against its ``param_shardings`` block,
    the params and both moments after the step, within 1e-5 of the JAX
    package's jitted sharded step (the params by ``TINY_GRAD``'s rule); one
    gradient all-reduce (the leaves whole over ``data``: the FSDP leaves
    were reduce-scattered in the backward)."""
    _matches_jax(run, name, runs)


@pytest.mark.parametrize("run,name", JAX_RUNS)
def test_jax_layout_replicas_are_bit_equal(run, name, runs):
    """After a step in the JAX layout, every leaf is bit-equal on the ranks
    that hold the same block of it; the metrics on every rank."""
    _replicas_equal(run, name, runs)


@pytest.mark.parametrize("run,name", JAX_RUNS)
def test_jax_layout_bytes_a_rank_equal_jax(run, name, runs):
    """The params and AdamW state a rank holds after the step, to the byte
    the state one device holds after the JAX package's step."""
    ref, ranks, _ = runs
    want = ref["fsdp" if run == "fsdp" else "steps"][name]["bytes"]
    assert [r["steps"][run, name]["bytes"] for r in ranks] == [want] * len(ranks)


@pytest.mark.parametrize("name", GLOBAL_CASES)
def test_rank_rows_step_equals_global_batch_step(name, runs):
    """The step on each rank's rows alone against the step on the global
    batch that every rank holds (each microbatch a slice of it): loss and
    metrics, gradients, moments and the updated params within 1e-6 on
    every rank (the params by ``TINY_GRAD``'s rule), one gradient
    all-reduce each; the MoE routes the same rows a data shard."""
    _, ranks, _ = runs
    for rank, r in enumerate(ranks):
        got, want = r["steps"]["jax", name], r["steps"]["global", name]
        assert got["grad_calls"] == want["grad_calls"] == 1
        for k, v in got["metrics"].items():
            close(v, want["metrics"][k].numpy(), GLOBAL_TOL, f"{k} rank {rank}")
        for part in ("grads", "m", "v", "params"):
            assert sorted(got[part]) == sorted(want[part])
            for path, t in got[part].items():
                w = want[part][path].numpy()
                if part == "params":
                    tiny = np.abs(want["m"][path].numpy()) / (1 - OPT_CFG.b1) < TINY_GRAD
                    assert (np.abs(t.numpy() - w)[tiny] <= 2 * OPT_CFG.lr).all(), (path, rank)
                    w = np.where(tiny, t.numpy(), w)
                close(t, w, GLOBAL_TOL, f"{part} {path} rank {rank}")


def test_rank_pipeline_reads_the_global_readers_block():
    """The launcher's reader of a rank's rows (the batch shards as
    ``TokenPipeline``'s ranks) yields, bit for bit, that rank's
    ``batch_shardings`` block of what the one global reader yields, step
    after step, on (2, 2) and (4, 1); a batch that does not divide is read
    whole."""
    from repro_torch.core.cluster import Cluster
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline, write_token_corpus
    from repro_torch.launch.train import bigram_corpus, corpus_tokens, pipeline_config

    batch, seq = 8, 16
    cluster = Cluster(n_data_providers=2, n_metadata_providers=2)
    try:
        n = corpus_tokens(batch, seq)
        handle = write_token_corpus(cluster.session(), bigram_corpus(512, n, np.random.default_rng(0)))
        whole = TokenPipeline(handle, n, PipelineConfig(batch_per_rank=batch, seq_len=seq, n_ranks=1, rank=0))
        for shape in ((2, 2), (4, 1)):
            for rank in range(4):
                ai = _axis_info(rank, shape)
                cfg = pipeline_config(batch, seq, 0, ai)
                assert (cfg.n_ranks, cfg.rank) == (shape[0], rank // shape[1])
                mine = TokenPipeline(handle, n, cfg)
                for step in (0, 1, 5):
                    want = whole.batch_at(step)
                    specs = shd.batch_shardings(want, None, ai)
                    for k, v in mine.batch_at(step).items():
                        np.testing.assert_array_equal(v, shd.shard_leaf(want[k], specs[k], ai))
        odd = pipeline_config(6, seq, 0, _axis_info(1, (4, 1)))
        assert (odd.batch_per_rank, odd.n_ranks, odd.rank) == (6, 1, 0)
    finally:
        cluster.close()


@pytest.mark.parametrize("form", ["tp_gather", "tp_block", "fsdp", "gather_blocks"])
def test_collective_forms_match_the_unsharded_gradient(form, runs):
    """Each autograd form on 4 gloo ranks: the gradients of the rows and of
    the weight blocks, summed over the data ranks where the rows are split
    (FSDP's are summed by its reduce-scatter), equal the unsharded
    product's. ``gather_blocks`` over the model axis in ``tp_gather``'s
    place sums cotangents that every model rank already holds whole, so its
    gradients are the unsharded ones times the axis size: the factor is
    there, and is why the model axis needs its own forms."""
    _, ranks, _ = runs
    t = {k: torch.from_numpy(v).requires_grad_(k in "xwu") for k, v in form_inputs().items()}
    gx, gw, gu = torch.autograd.grad(form_loss(form, t["x"], t["w"], t["u"], t["c"]), [t["x"], t["w"], t["u"]],
                                     allow_unused=True)
    factor = 2.0 if form == "gather_blocks" else 1.0
    for rank, r in enumerate(ranks):
        i, j = divmod(rank, 2)
        got = r["forms"][form]
        close(got["x"], factor * gx[i * FORM_ROWS:(i + 1) * FORM_ROWS], what=f"x rank {rank}")
        if form == "fsdp":
            for g, w in zip(got["w"], [gw.chunk(2, 0)[i], gu.chunk(2, 0)[i]]):
                close(g, w, what=f"w rank {rank}")
            continue
        # the row shards' shares of a block, summed over the data ranks
        total = got["w"][0] + ranks[(i ^ 1) * 2 + j]["forms"][form]["w"][0]
        want = gw.chunk(2, 0 if form == "tp_block" else 1)[j]
        close(total, factor * want, what=f"w rank {rank}")


@pytest.mark.parametrize("routed", ["local", "replicated"])
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_gradients_match_jax_shard_map(name, routed, runs):
    """The MoE layer routing each rank's data shard (``local_batch``, a
    rank's loss its share), or every token on every rank (a replicated
    batch: each rank routes its block, regathered, and takes 1/2 of the
    loss): the gradients of the router, the experts (a rank's block) and
    the tokens (a rank's rows, or all of them summed over the data ranks),
    aux included, within 1e-5 of ``jax.grad`` through the JAX package's
    ``moe_ffn(axis_info)``; the aux the same on every rank."""
    ref, ranks, _ = runs
    want = ref["moe"][name]
    for rank, r in enumerate(ranks):
        got = r["moe"][f"{name}-{routed}"]
        a, b = got["rows"]
        close(got["x"], want["x"][a:b])
        ai = _axis_info(rank)
        cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke(), n_experts=MOE_CASES[name])
        specs = shd.local_param_specs({"blocks": {"ffn": {k: (1, *v.shape) for k, v in want["grads"].items()}}},
                                      cfg, ai)["blocks"]["ffn"]
        for k, g in got["params"].items():
            full = want["grads"][k][None]
            close(g, (shd.shard_leaf(full, specs[k], ai) if len(specs[k]) else full)[0])
        assert torch.equal(got["aux"], ranks[0]["moe"][f"{name}-{routed}"]["aux"])
