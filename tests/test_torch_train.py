"""The port's training path (``repro_torch.models.layers``' rmsnorm VJP and
cross-entropy, ``ops.flash_attention(impl="xla")``, remat, every family's
``train_loss``, AdamW, ``make_train_step`` and the launcher) against the JAX
package on the CPU, on inputs made with numpy from a seed and JAX-initialised
weights (crossing through ``params_from_jax``). The JAX calls are jitted.

Tolerances: rmsnorm 1e-6 in f32, 1e-2 in bf16; cross-entropy 1e-6; attention
1e-5 in f32, 2e-2 in bf16; a family's loss 1e-5 and each gradient leaf within
1e-4 of its largest |value|; AdamW 1e-6 relative; three train steps 1e-5.
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models.lm import build_model as jax_build_model  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_axis_info, make_mesh_for_devices  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

FAMILIES = ["llama3_2-1b", "mixtral-8x7b", "chameleon-34b", "mamba2-370m", "zamba2-2.7b", "seamless-m4t-medium"]


def configs(arch, **overrides):
    return (dataclasses.replace(jax_get_config(arch).smoke(), **overrides),
            dataclasses.replace(get_config(arch).smoke(), **overrides))


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    jcfg, _ = configs(arch)
    model = jax_build_model(jcfg)
    return jax.tree.map(np.asarray, jax.jit(lambda key: model.init(key)[0])(jax.random.PRNGKey(0)))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def both(x: np.ndarray, dtype="float32"):
    return jnp.asarray(x).astype(dtype), torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def flat(tree, path=()):
    """{path: leaf} of a tree of dicts."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in flat(tree[k], path + (k,)).items()}
    return {path: tree}


def tracked(tree):
    """The tree's tensors as leaves autograd differentiates."""
    if isinstance(tree, dict):
        return {k: tracked(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def make_batch(cfg, B=4, S=32, seed=0):
    """The JAX package's batch dict: tokens and labels (a few -1, padding),
    ``embeds`` for a vlm backbone, ``enc_embeds`` for the encoder-decoder."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        del batch["tokens"]
    if cfg.family in ("encdec", "audio"):
        batch["enc_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def loss_and_grads(model, params, batch):
    """(loss, metrics, {path: grad}) of the port's ``train_loss``."""
    p = tracked(params)
    loss, metrics = model.train_loss(p, torch_batch(batch))
    paths = flat(p)
    grads = torch.autograd.grad(loss, list(paths.values()))
    return loss.detach(), metrics, dict(zip(paths, grads))


# ------------------------------ rmsnorm and cross-entropy ------------------------------
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_rmsnorm_forward_and_vjp_match_jax(dtype, tol):
    rng = np.random.default_rng(0)
    x, s, g = (rng.standard_normal(shape).astype(np.float32) for shape in ((3, 5, 64), (64,), (3, 5, 64)))
    (jx, tx), (jg, tg) = both(x, dtype), both(g, dtype)
    js, ts = jnp.asarray(s), torch.from_numpy(s).requires_grad_(True)  # scale f32, as a norm's param
    jy, vjp = jax.vjp(jax.jit(jlayers.rmsnorm), jx, js)
    jdx, jds = vjp(jg)
    tx.requires_grad_(True)
    ty = layers.rmsnorm(tx, ts)
    tdx, tds = torch.autograd.grad(ty, (tx, ts), tg)
    assert (str(ty.dtype), str(tdx.dtype), str(tds.dtype)) == (f"torch.{dtype}", f"torch.{dtype}", "torch.float32")
    close(ty, jy, tol)
    close(tdx, jdx, tol)
    close(tds, jds, tol)


def test_rmsnorm_gradcheck_f64():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8))).requires_grad_(True)
    s = torch.from_numpy(rng.standard_normal(8)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: layers.rmsnorm(a, b), (x, s))


def test_cross_entropy_matches_jax_with_padding():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 512)).astype(np.float32) * 3
    labels = rng.integers(0, 500, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 6] = -1
    logits[1, 2, labels[1, 2]] = 50.0  # at least one right guess
    fn = jax.jit(lambda lg: jlayers.cross_entropy(lg, jnp.asarray(labels), 500))
    jloss, jacc = fn(jnp.asarray(logits))
    jgrad = jax.grad(lambda lg: fn(lg)[0])(jnp.asarray(logits))
    tl =torch.from_numpy(logits).requires_grad_(True)
    loss, acc = layers.cross_entropy(tl, torch.from_numpy(labels), 500)
    (tgrad,) = torch.autograd.grad(loss, tl)
    assert float(acc) > 0
    close(loss, jloss, 1e-6)
    close(acc, jacc, 1e-6)
    close(tgrad, jgrad, 1e-6)


# ------------------------------ attention: impl="xla" ------------------------------
# (B, Sq, Sk, H, K, D, causal, window, q_start, q_chunk)
XLA_CASES = {
    "causal_tiled": (2, 64, 64, 4, 4, 16, True, None, 0, 16),  # Sq >= 2 q_chunk: the recursion
    "windowed": (2, 96, 96, 4, 4, 16, True, 32, 0, 16),  # Sk > window + q_chunk: key slices
    "noncausal_cross": (2, 32, 48, 4, 4, 16, False, None, 0, 16),
    "q_start": (2, 32, 64, 4, 4, 16, True, None, 32, 16),
    "gqa": (2, 64, 64, 8, 2, 16, True, None, 0, 16),
}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_xla_attention_and_grads_match_jax(case, dtype, tol):
    B, Sq, Sk, H, K, D, causal, window, q_start, q_chunk = XLA_CASES[case]
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]
    cot = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_start=q_start, q_chunk=q_chunk)
    jargs = [both(a, dtype)[0] for a in arrays]
    jo, vjp = jax.vjp(jax.jit(lambda q, k, v: jops.flash_attention(q, k, v, impl="xla", **kw)), *jargs)
    jgrads = vjp(both(cot, dtype)[0])
    targs = [both(a, dtype)[1].requires_grad_(True) for a in arrays]
    to = ops.flash_attention(*targs, impl="xla", **kw)
    tgrads = torch.autograd.grad(to, targs, both(cot, dtype)[1])
    assert to.dtype == targs[0].dtype
    close(to, jo, tol)
    for t, j in zip(tgrads, jgrads):
        close(t, j, tol)


# ------------------------------ every family's train_loss ------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_jax(arch):
    jcfg, tcfg = configs(arch)
    jmodel = jax_build_model(jcfg)
    batch = make_batch(jcfg)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jmodel.train_loss(p, b, None), has_aux=True))
    (jloss, jmetrics), jgrads = grad_fn(jax_params(arch), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = loss_and_grads(build_model(tcfg), params_from_jax(jax_params(arch), tcfg, "cpu"), batch)
    assert sorted(metrics) == sorted(jmetrics)
    close(loss, jloss, 1e-5)
    for k in metrics:
        close(metrics[k], jmetrics[k], 1e-5)
    jflat = flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(grads) == sorted(jflat)
    for path, g in grads.items():
        want = jflat[path]
        err = np.abs(as_np(g) - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (path, err)


def _count_mms_in_backward(cfg, params, batch):
    """aten.mm calls while the loss's backward runs (remat's recompute
    included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    p = tracked(params)
    loss, _ = build_model(cfg).train_loss(p, torch_batch(batch))
    with Count():
        torch.autograd.grad(loss, list(flat(p).values()))
    return Count.n


@pytest.mark.parametrize("remat,group", [("full", 1), ("dots", 1), ("full", 2), ("dots", 2)])
def test_remat_gives_the_same_loss_and_grads(remat, group):
    """Remat changes what is saved, not what is computed: the loss and every
    gradient equal ``remat="none"``'s; ``"full"`` recomputes the forward's
    projections in the backward pass, ``"dots"`` keeps them."""
    _, base = configs("mixtral-8x7b")
    params = params_from_jax(jax_params("mixtral-8x7b"), base, "cpu")
    batch = make_batch(base)
    cfg = dataclasses.replace(base, remat=remat, remat_group=group)
    want_loss, _, want = loss_and_grads(build_model(base), params, batch)
    loss, _, got = loss_and_grads(build_model(cfg), params, batch)
    close(loss, want_loss, 1e-6)
    for path, g in got.items():
        close(g, want[path], 1e-6)
    n_none, n = _count_mms_in_backward(base, params, batch), _count_mms_in_backward(cfg, params, batch)
    assert (n > n_none) if remat == "full" else (n == n_none), (n, n_none)


# ------------------------------ AdamW ------------------------------
OPT = dict(lr=1e-2, warmup_steps=4, total_steps=20)


@pytest.mark.parametrize("step", [0, 2, 4, 12, 20, 25])
def test_lr_at_matches_jax(step):
    cfg_j, cfg_t = jopt.AdamWConfig(**OPT), opt.AdamWConfig(**OPT)
    want = jax.jit(lambda s: jopt.lr_at(s, cfg_j))(jnp.int32(step))
    got = opt.lr_at(torch.tensor(step, dtype=torch.int32), cfg_t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adamw_update_matches_jax():
    """Two steps on a tree of f32 and bf16 params, the grads scaled so the
    first step clips and the second does not."""
    rng = np.random.default_rng(4)
    shapes = {"a": (8, 16), "b": {"c": (16,), "d": (4, 4, 4)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    jp = jax.tree.map(jnp.asarray, params)
    jp["b"]["d"] = jp["b"]["d"].astype(jnp.bfloat16)
    tp = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), params)
    tp["b"]["d"] = tp["b"]["d"].to(torch.bfloat16)
    jstate, tstate = jopt.adamw_init(jp), opt.adamw_init(tp)
    update = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jopt.AdamWConfig(**OPT)))
    for scale in (10.0, 0.1):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32), params)
        jp, jstate, jm = update(jp, jax.tree.map(jnp.asarray, grads), jstate)
        tp, tstate, tm = opt.adamw_update(tp, jax.tree.map(torch.from_numpy, grads), tstate, opt.AdamWConfig(**OPT))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 2 and tstate["step"].dtype == torch.int32
    for tree_t, tree_j in ((tp, jp), (tstate["m"], jstate["m"]), (tstate["v"], jstate["v"])):
        jflat = flat(tree_j)
        for path, t in flat(tree_t).items():
            assert str(t.dtype).removeprefix("torch.") == str(jflat[path].dtype)
            np.testing.assert_allclose(as_np(t), as_np(jflat[path]), rtol=1e-6, atol=1e-7)


# ------------------------------ make_train_step ------------------------------
@pytest.mark.parametrize("arch", ["llama3_2-1b", "mixtral-8x7b"])
def test_train_steps_with_grad_accum_match_jax(arch):
    """Three steps of 8 rows in 4 microbatches from the same weights. lr
    1e-3: AdamW divides each gradient element by its own magnitude, so the
    gradients' last-bit differences (summation order) reach the params as
    about lr times their relative size; at 1e-3 that stays within 1e-5."""
    jcfg, tcfg = configs(arch, grad_accum=4)
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jcfg, None, jopt.AdamWConfig(**oc)))
    tstep = make_train_step(build_model(tcfg), tcfg, opt.AdamWConfig(**oc))
    jp, js = jax_params(arch), jopt.adamw_init(jax_params(arch))
    tp = params_from_jax(jax_params(arch), tcfg, "cpu")
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), tcfg, "cpu")
    for step in range(3):
        batch = make_batch(jcfg, B=8, S=32, seed=step)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, torch_batch(batch))
        assert sorted(tm) == sorted(jm)
        for k in tm:
            close(tm[k], jm[k], 1e-5)
    assert int(ts["step"]) == int(js["step"]) == 3
    jflat = flat(jax.tree.map(np.asarray, jp))
    for path, t in flat(tp).items():
        close(t, jflat[path], 1e-5)


def test_sharded_and_pallas_training_raise():
    """The sharded step on a one-rank mesh (every collective the identity)
    gives the single-device step's numbers; the launcher's model axis must
    divide the world (one process here), as the JAX launcher's mesh
    requires; a Pallas config and an unknown impl still raise."""
    _, cfg = configs("mixtral-8x7b", n_layers=2)
    model = build_model(cfg)
    ai = make_axis_info(make_mesh_for_devices())
    batch = torch_batch(make_batch(cfg, B=8, S=16))
    out = []
    for axis_info in (None, ai):
        params = model.init(0, "cpu")
        step = make_train_step(model, cfg, opt.AdamWConfig(), axis_info=axis_info)
        out.append(step(params, opt.adamw_init(params), batch))
    (p1, s1, m1), (p2, s2, m2) = out
    for k in m1:
        close(m2[k], m1[k], 1e-6)
    for a, b in zip(opt.leaves(s2["m"]) + opt.leaves(p2), opt.leaves(s1["m"]) + opt.leaves(p1)):
        close(a, b, 1e-6)
    with pytest.raises(ValueError, match="model_parallel=2"):
        train("llama3_2-1b", smoke=True, model_parallel=2, device="cpu")
    pallas = build_model(dataclasses.replace(cfg, use_pallas=True))
    with pytest.raises(NotImplementedError, match="no backward"):
        pallas.train_loss(model.init(0, "cpu"), batch)
    with pytest.raises(ValueError, match="impl"):
        model.train_loss(model.init(0, "cpu"), batch, impl=None)


# ------------------------------ the launcher ------------------------------
def test_launcher_loss_decreases():
    out = train("llama3_2-1b", smoke=True, steps=30, batch=8, seq=64, checkpoint_every=100, lr=1e-2,
                device="cpu")
    losses = out["losses"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses


def test_launcher_checkpoint_restart_resumes_identically():
    """20 steps; separately 14 steps that crash (a checkpoint at step 10),
    then a rerun with ``restore`` on the same session: the same final loss,
    as tests/test_train_integration.py asks of the JAX launcher."""
    from repro_torch.core import Cluster

    a = train("llama3_2-1b", smoke=True, steps=20, batch=4, seq=64, checkpoint_every=10, seed=3, device="cpu")
    cluster = Cluster(n_data_providers=4, n_metadata_providers=4, shared_cache_bytes=0)
    try:
        session = cluster.session()
        with pytest.raises(RuntimeError, match="injected failure"):
            train("llama3_2-1b", smoke=True, steps=20, batch=4, seq=64, checkpoint_every=10, seed=3,
                  session=session, fail_at_step=14, device="cpu")
        b = train("llama3_2-1b", smoke=True, steps=20, batch=4, seq=64, checkpoint_every=10, seed=3,
                  session=session, restore=True, device="cpu")
    finally:
        cluster.close()
    np.testing.assert_allclose(a["losses"][-1], b["losses"][-1], rtol=1e-4)
