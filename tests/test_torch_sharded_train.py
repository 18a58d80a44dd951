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
mesh, with the JAX package's weights (``params_from_jax(axis_info=)``: each
rank keeps its experts), for the dense, moe (under full remat, so that the
collectives run again in the recomputation), ssm, hybrid and audio families
at smoke width with 2 layers, B = 8 rows of S = 16 tokens, some labels -1
(padding, unevenly over the rows, so that each share's divisor must be the
whole microbatch's count), ``grad_accum`` 4 (four microbatches of two rows,
one row a data shard).

Held, each within 1e-5: the loss and metrics, every gradient leaf, the
updated params and the moments (an expert leaf against its block of JAX's);
replicated leaves bit-equal on every rank, expert leaves bit-equal across
the data ranks. The MoE layer's sharded gradients (router, tokens, experts;
aux weight 1, EP with 4 experts and expert-TP with 3) against ``jax.grad``
through the JAX package's ``moe_ffn(axis_info)``, also within 1e-5.
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

    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    ai = AxisInfo(mesh, batch_axes=("data",), model_axis="model")
    inner = jtrainer.adamw_update

    def with_grads(params, grads, state, cfg):  # the gradients the step applies, as a metric
        params, state, metrics = inner(params, grads, state, cfg)
        return params, state, dict(metrics, grads=grads)

    jtrainer.adamw_update = with_grads
    out = {"steps": {}, "moe": {}}
    for name, (arch, _) in CASES.items():
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
        out["steps"][name] = jax.tree.map(np.asarray, {
            "params0": params, "params": new_p, "m": new_s["m"], "v": new_s["v"],
            "grads": metrics.pop("grads"), "metrics": metrics})
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


# ------------------------------ the port, on 4 ranks ------------------------------
def _train_rank(ai, chosen, steps_in, moe_in):
    """One sharded step of every case, capturing the gradients the update
    applies; then the MoE layer's gradient shares, summed over the data axis."""
    out = {"steps": {}, "moe": {}}
    inner, inner_reduce = trainer.adamw_update, trainer.reduce_gradients
    seen = {}

    def capture(params, grads, state, cfg, gnorm=None):
        seen["grads"] = {k: v.clone() for k, v in _flat(grads).items()}
        return inner(params, grads, state, cfg, gnorm=gnorm)

    def count_reduce(grads, axis_info):
        calls = collectives.stats["calls"]
        inner_reduce(grads, axis_info)
        seen["grad_calls"] += collectives.stats["calls"] - calls

    trainer.adamw_update, trainer.reduce_gradients = capture, count_reduce
    for name, jparams in steps_in.items():
        arch, _ = CASES[name]
        cfg = dataclasses.replace(get_config(arch).smoke(), **smoke_overrides(name))
        params = params_from_jax(jparams, cfg, "cpu", axis_info=ai)
        state = opt.adamw_init(params)
        step = trainer.make_train_step(build_model(cfg), cfg, opt.AdamWConfig(**OPT), axis_info=ai,
                                       param_shardings=shd.local_param_specs(params, cfg, ai))
        batch = {k: torch.from_numpy(v) for k, v in make_batch(name).items()}
        seen["grad_calls"] = 0
        params, state, metrics = step(params, state, batch)
        out["steps"][name] = {"params": _flat(params), "m": _flat(state["m"]), "v": _flat(state["v"]),
                              "grads": seen["grads"], "metrics": metrics, "grad_calls": seen["grad_calls"]}
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


def _spec(name, path, ai):
    """The spec of a leaf as the port holds it (P() but for experts)."""
    from repro_torch.convert import param_shapes

    arch, _ = CASES[name]
    cfg = dataclasses.replace(get_config(arch).smoke(), **smoke_overrides(name))
    return _flat(shd.local_param_specs(param_shapes(cfg), cfg, ai))[path]


def _block(flat, name, path, ai):
    """JAX's leaf at ``path``, cut to the block this rank keeps (an expert leaf)."""
    spec = _spec(name, path, ai)
    return shd.shard_leaf(flat[path], spec, ai) if len(spec) else flat[path]


def _axis_info(rank):
    return launch_mesh.make_axis_info(shd.Mesh((2, 2), ("data", "model"), rank=rank))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_jax_sharded_step(name, runs):
    """Loss and metrics, every gradient leaf, the updated params and both
    moments on every rank within 1e-5 of the JAX package's sharded step
    (an expert leaf against its block; the params where the clipped
    gradient is not within ``TINY_GRAD`` of zero, and within one lr of
    the old params where it is); the gradients cross in one all-reduce
    (one bucket at smoke size)."""
    ref, ranks, _ = runs
    want = ref["steps"][name]
    jflat = {k: _flat(want[k]) for k in ("grads", "params", "m", "v", "params0")}
    for rank, r in enumerate(ranks):
        got = r["steps"][name]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, v in got["metrics"].items():
            close(v, want["metrics"][k])
        assert got["grad_calls"] == 1
        ai = _axis_info(rank)
        for part in ("grads", "params", "m", "v"):
            assert sorted(got[part]) == sorted(jflat[part])
            for path, t in got[part].items():
                want_t = _block(jflat[part], name, path, ai)
                if part == "params":  # where the clipped gradient is tiny, within one lr (the docstring's rule)
                    tiny = np.abs(_block(jflat["m"], name, path, ai)) / (1 - OPT_CFG.b1) < TINY_GRAD
                    step = np.abs(t.numpy() - _block(jflat["params0"], name, path, ai))
                    assert (step[tiny] <= OPT_CFG.lr).all(), (path, rank)
                    want_t = np.where(tiny, t.numpy(), want_t)
                close(t, want_t, what=f"{part} {path} rank {rank}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_is_the_same_on_every_rank(name, runs):
    """After the step, replicated leaves are bit-equal on all four ranks
    and expert leaves across the data ranks (ranks r and r + 2 of the
    (data 2, model 2) mesh share a model coordinate); the metrics are
    equal everywhere."""
    _, ranks, _ = runs
    for part in ("params", "m", "v", "grads"):
        for path in ranks[0]["steps"][name][part]:
            groups = [(0, 2), (1, 3)] if len(_spec(name, path, _axis_info(0))) else [(0, 1, 2, 3)]
            for group in groups:
                first = ranks[group[0]]["steps"][name][part][path]
                for rank in group[1:]:
                    assert torch.equal(ranks[rank]["steps"][name][part][path], first), (part, path, rank)
    for r in ranks:
        for k, v in r["steps"][name]["metrics"].items():
            assert torch.equal(v, ranks[0]["steps"][name]["metrics"][k])


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
