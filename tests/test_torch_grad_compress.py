"""The int8 error-feedback pod mean (``repro_torch.train.grad_compress``) and
the launcher across ranks, against the JAX package on the CPU.

``compressed_pod_mean`` runs on 4 spawned gloo ranks of a ``(pod 2, data 2)``
mesh (with a model axis of 1) and, in a subprocess with 4 forced host
devices, the JAX package's on a ``(pod 2, data 2)`` mesh built with
``AxisType.Auto`` axes (``jax.make_mesh``'s default in jax 0.9.0 is
Explicit, see ``tests/test_torch_sharded_train.py``). The pods' gradients
differ: JAX is fed each leaf sharded over ``pod`` (and one over
``(pod, data)``, a leaf whose data ranks hold different blocks), the port
each rank's block. Held to JAX's means and residuals bit for bit (f32
and bf16 leaves), over two steps (the residual fed back), and to the
properties of ``tests/test_grad_compress.py``'s three tests, ported.

The launcher: ``train(model_parallel=2)`` on a ``(data 2, model 2)`` mesh of
4 ranks for llama (dense) and mixtral (experts over the model axis), the
state in the JAX package's layout, then the step-6 checkpoint restored onto
a ``(data 4, model 1)`` mesh equals the final params bit for bit (the port
of ``test_distributed_train_smoke_and_elastic_reshard``); llama's sharded
losses are the single-device launcher's within 1e-4, and its step-3
checkpoint resumes on the ``(data 4, model 1)`` mesh to the uninterrupted
run's losses within 1e-4. Last, ``chip_smoke.py``'s
step 16 end to end at smoke size on 4 CPU ranks.
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
from repro_torch.core.cluster import Cluster  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch.train import maybe_init_distributed, state_specs, train  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.axisinfo import AxisInfo, Mesh  # noqa: E402
from repro_torch.storage.checkpoint import restore_onto_mesh  # noqa: E402
from repro_torch.train.grad_compress import compressed_pod_mean, ef_init  # noqa: E402

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
DEADLINE_S = 300.0  # a hang ends here; the driver runs several test files at once
EF_STEPS, EF_G = 50, 0.3017
LAUNCH = dict(smoke=True, steps=6, batch=8, seq=32, checkpoint_every=3, lr=1e-3, device="cpu")
LAUNCH_ARCHS = ("llama3_2-1b", "mixtral-8x7b")


def differing_grads(step: int):
    """Global leaves, each block a pod's (or a (pod, data) rank's)
    gradient: ``w`` f32 over ``pod``, ``b`` f32 over ``(pod, data)``, ``e``
    bf16 values (kept f32 here) over ``pod``."""
    rng = np.random.default_rng(step)
    e = rng.standard_normal((12, 5)).astype(np.float32) * np.array([[1.0]] * 6 + [[30.0]] * 6, np.float32)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32) * 0.01,
            "b": rng.standard_normal((8,)).astype(np.float32),
            "e": e}


SPLIT = {"w": ("pod",), "b": ("pod", "data"), "e": ("pod",)}
DTYPE = {"w": "float32", "b": "float32", "e": "bfloat16"}


def same_grads():
    """``tests/test_grad_compress.py``'s gradients, the same on every pod."""
    return {"w": np.linspace(-1.0, 1.0, 64, dtype=np.float32).reshape(8, 8),
            "b": np.full((4,), 0.5, np.float32)}


# ------------------------------ the JAX package, in a subprocess ------------------------------
def _jax_pod_means(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.parallel.axisinfo import AxisInfo as JAxisInfo
    from repro.train.grad_compress import compressed_pod_mean as jmean
    from repro.train.grad_compress import ef_init as jef_init

    mesh = jax.make_mesh((2, 2), ("pod", "data"), axis_types=(AxisType.Auto, AxisType.Auto))
    ai = JAxisInfo(mesh, batch_axes=("pod", "data"), model_axis="data")
    specs = {k: JP(v) for k, v in SPLIT.items()}
    fn = jax.jit(lambda g, e: jmean(g, e, ai, specs))
    out = {"differ": []}
    err = None
    for step in range(2):
        g = {k: jax.device_put(jnp.asarray(v).astype(DTYPE[k]), NamedSharding(mesh, specs[k]))
             for k, v in differing_grads(step).items()}
        err = jef_init(g) if err is None else err
        mean, err = fn(g, err)
        out["differ"].append(jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), {"mean": mean, "err": err}))
    g = {k: jnp.asarray(v) for k, v in same_grads().items()}
    mean, err = jax.jit(lambda g, e: jmean(g, e, ai, {"w": JP(), "b": JP()}))(g, jef_init(g))
    out["same"] = jax.tree.map(np.asarray, {"mean": mean, "err": err})
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


# ------------------------------ the port, on 4 ranks ------------------------------
def _block(x: np.ndarray, axes, ai):
    return shd.shard_leaf(x, shd.P(axes), ai)


def _grads_rank(ai, chosen, launch_ref):
    """The pod means on a (pod 2, data 2, model 1) mesh, then the launcher
    on the spawned (data 2, model 2) mesh and the elastic restore."""
    pod_ai = launch_mesh.make_axis_info(launch_mesh.make_mesh((2, 2, 1), ("pod", "data", "model")))
    out = {"coords": pod_ai.mesh.coords(), "differ": []}
    err = None
    for step in range(2):
        g = {k: torch.from_numpy(np.ascontiguousarray(_block(v, SPLIT[k], pod_ai))).to(getattr(torch, DTYPE[k]))
             for k, v in differing_grads(step).items()}
        err = ef_init(g) if err is None else err
        mean, err = compressed_pod_mean(g, err, pod_ai, None)
        out["differ"].append({"mean": mean, "err": err})
    g = {k: torch.from_numpy(v) for k, v in same_grads().items()}
    out["same"] = dict(zip(("mean", "err"), compressed_pod_mean(g, ef_init(g), pod_ai, None)))
    g, err, means = {"w": torch.full((16,), EF_G)}, None, []
    err = ef_init(g)
    for _ in range(EF_STEPS):
        mean, err = compressed_pod_mean(g, err, pod_ai, None)
        means.append(mean["w"])
    out["ef_mean"] = torch.stack(means).mean(dim=0)

    out["launch"] = {}
    for arch in LAUNCH_ARCHS:
        cluster = Cluster(n_data_providers=4, n_metadata_providers=4)  # outlives the run: the restore reads it
        try:
            run = train(arch, model_parallel=2, session=cluster.session(), **LAUNCH)
            cfg = get_config(arch).smoke()
            final = shd.gather_params(run["params"], cfg, run["axis_info"])
            ai2 = launch_mesh.make_axis_info(launch_mesh.make_mesh((4, 1), ("data", "model")))
            state = restore_onto_mesh(run["checkpointer"], state_specs(cfg, ai2), ai2, step=6, device="cpu")
            resumed = _resume_on(run, cfg, ai2, 3) if arch == "llama3_2-1b" else None
        finally:
            cluster.close()
        restored = {"params": shd.gather_params(state["params"], cfg, ai2),  # its (data 4, model 1) blocks
                    "m": shd.gather_params(state["opt"]["m"], cfg, ai2)}
        out["launch"][arch] = {
            "losses": run["losses"],
            "restored_equal": all(torch.equal(a, b) for a, b in zip(_leaves(restored["params"]), _leaves(final))),
            "moments_equal": all(torch.equal(a, b) for a, b in zip(
                _leaves(restored["m"]), _leaves(shd.gather_params(run["opt_state"]["m"], cfg, run["axis_info"])))),
            "step": int(state["opt"]["step"]),
            "checkpoints": None if run["checkpointer"] is None else [c.step for c in run["checkpointer"].checkpoints],
            "resumed_losses": resumed,
        }
    return out


def _resume_on(run, cfg, ai, step: int) -> list:
    """The launcher's step-``step`` checkpoint (the JAX layout on the run's
    mesh) restored onto ``ai``'s mesh, and trained from there to the end
    on the run's batches (each rank reading its rows of them, as the
    launcher reads them on ``ai``'s mesh), with the launcher's config and
    schedule; the losses of those steps."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import pipeline_config
    from repro_torch.models.lm import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import make_train_step

    state = restore_onto_mesh(run["checkpointer"], state_specs(cfg, ai), ai, step=step, device="cpu")
    params, opt_state = state["params"], state["opt"]
    cfg = dataclasses.replace(cfg, grad_accum=min(cfg.grad_accum, max(LAUNCH["batch"] // 2, 1)))
    opt_cfg = AdamWConfig(lr=LAUNCH["lr"], total_steps=LAUNCH["steps"], warmup_steps=max(LAUNCH["steps"] // 10, 1))
    step_fn = make_train_step(build_model(cfg), cfg, opt_cfg, ai)
    pipe = run["pipeline"]
    mine = TokenPipeline(pipe.handle, pipe.n_tokens, pipeline_config(LAUNCH["batch"], LAUNCH["seq"], pipe.cfg.seed, ai))
    losses = []
    for s in range(step, LAUNCH["steps"]):
        batch = {k: torch.from_numpy(v) for k, v in mine.batch_at(s).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch, LAUNCH["batch"])
        losses.append(float(metrics["loss"]))
    return losses


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grad_compress")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    code = f"import test_torch_grad_compress as t; t._jax_pod_means({str(tmp / 'jax.pkl')!r})"
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        ranks = launch_mesh.spawn(_grads_rank, 4, (None,), model_parallel=2, device="cpu", timeout_s=DEADLINE_S)
        single = train("llama3_2-1b", **LAUNCH)["losses"]
        log, _ = proc.communicate(timeout=DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-6000:]
    with open(tmp / "jax.pkl", "rb") as fh:
        ref = pickle.load(fh)
    return ref, ranks, single


def test_pod_means_of_differing_pods_match_jax(runs):
    """Two steps (the residual fed back) of pods whose gradients differ:
    each rank's mean and residual equal to JAX's block, bit for bit; the mean
    within one quantization step of the exact pod mean; the means equal
    across the pods, bit for bit."""
    ref, ranks, _ = runs
    for step in range(2):
        exact = differing_grads(step)
        for r in ranks:
            pod_ai = AxisInfo(Mesh((2, 2, 1), ("pod", "data", "model"),
                                   rank=r["coords"]["pod"] * 2 + r["coords"]["data"]), ("pod", "data"))
            got = r["differ"][step]
            for k in SPLIT:
                want_mean = _block(ref["differ"][step]["mean"][k], SPLIT[k], pod_ai)
                want_err = _block(ref["differ"][step]["err"][k], SPLIT[k], pod_ai)
                np.testing.assert_array_equal(got["mean"][k].float().numpy(), want_mean)
                np.testing.assert_array_equal(got["err"][k].numpy(), want_err)
                if step == 0:  # no residual yet: the mean of the pods' blocks, within a step
                    blocks = [_block(exact[k], SPLIT[k], AxisInfo(Mesh((2, 2, 1), ("pod", "data", "model"),
                              rank=p * 2 + r["coords"]["data"]), ("pod", "data"))) for p in range(2)]
                    g = [torch.from_numpy(np.ascontiguousarray(b)).to(getattr(torch, DTYPE[k])).float().numpy()
                         for b in blocks]
                    scale = max(np.abs(x).max() for x in g) / 127.0
                    assert np.abs(got["mean"][k].float().numpy() - (g[0] + g[1]) / 2).max() <= scale * 1.01
            for other in ranks:
                if other["coords"]["data"] == r["coords"]["data"]:
                    for k in SPLIT:
                        assert torch.equal(other["differ"][step]["mean"][k], got["mean"][k])


def test_compressed_mean_close_to_exact(runs):
    """``tests/test_grad_compress.py``'s test on the port: gradients the
    same on every pod give themselves back within one quantization step,
    the residual is exactly what the mean left out; bit-equal to JAX."""
    ref, ranks, _ = runs
    grads = same_grads()
    for r in ranks:
        got = r["same"]
        for k, g in grads.items():
            scale = float(np.abs(g).max()) / 127.0
            np.testing.assert_allclose(got["mean"][k].numpy(), g, atol=scale * 1.01)
            np.testing.assert_allclose(got["err"][k].numpy(), g - got["mean"][k].numpy(), atol=1e-6)
            np.testing.assert_array_equal(got["mean"][k].numpy(), ref["same"]["mean"][k])
            np.testing.assert_array_equal(got["err"][k].numpy(), ref["same"]["err"][k])


def test_error_feedback_unbiased_over_steps(runs):
    """A constant gradient: with the residual fed back, the mean of 50
    compressed means converges to it (the JAX test's rtol)."""
    _, ranks, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["ef_mean"].numpy(), EF_G, rtol=2e-3)


def test_single_pod_is_identity():
    """No pod axis: the gradients and the residual come back as they are,
    with no collective (a mesh without process groups)."""
    ai = AxisInfo(Mesh((4, 2), ("data", "model")), ("data",))
    g = {"w": torch.arange(8.0)}
    err = ef_init(g)
    out, err2 = compressed_pod_mean(g, err, ai, {"w": shd.P()})
    assert out["w"] is g["w"] and err2 is err
    assert err["w"].dtype == torch.float32 and not err["w"].any()


@pytest.mark.parametrize("arch", LAUNCH_ARCHS)
def test_distributed_train_smoke_and_elastic_reshard(arch, runs):
    """``train(model_parallel=2)`` on a (data 2, model 2) mesh: finite
    losses, the same on every rank; only rank 0 holds the checkpoints
    (steps 3 and 6); the step-6 checkpoint restored onto a (data 4,
    model 1) mesh equals the final params and moments bit for bit on every
    rank. llama's losses are the single-device launcher's within 1e-4."""
    _, ranks, single = runs
    for rank, r in enumerate(ranks):
        got = r["launch"][arch]
        assert np.isfinite(got["losses"]).all() and got["losses"] == ranks[0]["launch"][arch]["losses"]
        assert got["checkpoints"] == ([3, 6] if rank == 0 else None)
        assert got["restored_equal"] and got["moments_equal"] and got["step"] == 6
    if arch == "llama3_2-1b":
        np.testing.assert_allclose(ranks[0]["launch"][arch]["losses"], single, rtol=1e-4)


def test_jax_layout_checkpoint_resumes_on_another_mesh(runs):
    """The launcher holds the state in the JAX layout (``param_shardings``
    on the (data 2, model 2) mesh: FSDP over ``data``); its step-3
    checkpoint, restored onto a (data 4, model 1) mesh, trains steps 3-5
    on the same batches to the uninterrupted run's losses within 1e-4, the
    same on every rank."""
    _, ranks, _ = runs
    want = ranks[0]["launch"]["llama3_2-1b"]["losses"][3:]
    for r in ranks:
        got = r["launch"]["llama3_2-1b"]["resumed_losses"]
        assert got == ranks[0]["launch"]["llama3_2-1b"]["resumed_losses"]
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_launcher_joins_the_group_the_environment_names(monkeypatch):
    """Without ``RANK``/``WORLD_SIZE`` or ``COORDINATOR_ADDRESS`` the
    launcher runs as one process."""
    for name in ("RANK", "WORLD_SIZE", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    assert maybe_init_distributed("cpu") is None


# ------------------------------ chip_smoke.py's step 16 at smoke size ------------------------------
def _chip_smoke_on_the_cpu():
    """``chip_smoke`` with the card's calls stubbed and step 16 cut to the
    smoke configs (llama 2 layers, mixtral 1), 64-token rows, on the CPU."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.mem_get_info = lambda *a, **k: (0, 0)
    cs._train_shard_configs = lambda: (
        dataclasses.replace(get_config("llama3_2-1b").smoke(), n_layers=2),
        dataclasses.replace(get_config("mixtral-8x7b").smoke(), n_layers=1))
    cs.TRAIN_SEQ, cs.TRAIN_SHARD_DEVICE = 64, "cpu"
    return cs


def _step16_rank(ai, chosen, *args):
    return _chip_smoke_on_the_cpu().train_sharded_rank(ai, chosen, *args)


def test_chip_smoke_step16_at_smoke_size(monkeypatch, tmp_path):
    """``chip_smoke.train_sharded_phase`` end to end on 4 CPU ranks: every
    check of (a)-(d) passes, neither kernel's counter moves."""
    saved = {n: getattr(torch.cuda, n) for n in ("synchronize", "reset_peak_memory_stats", "empty_cache",
                                                  "max_memory_allocated", "mem_get_info")}
    try:
        cs = _chip_smoke_on_the_cpu()
        cs.TRAIN_SHARD_DIR = tmp_path / "train_sharded"
        inner = launch_mesh.spawn
        monkeypatch.setattr(launch_mesh, "spawn", lambda fn, n, args, **kw: inner(
            _step16_rank, n, args, **{**kw, "device": "cpu", "timeout_s": DEADLINE_S}))
        out = cs.train_sharded_phase("cpu")
    finally:
        for n, f in saved.items():
            setattr(torch.cuda, n, f)
    assert out["launcher"]["restored_bit_equal"] and out["pod_mean"]["max_err_in_steps"] <= 1
    assert all(n == 0 for r in out["launches"] for n in r.values())
    assert out["llama"]["grad_allreduce_calls"] == [1] * cs.TRAIN_SHARD_STEPS and max(out["llama"]["loss_rel"]) < 1e-5
