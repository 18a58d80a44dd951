"""Port MoE layer vs the JAX package: ``repro_torch.models.moe.moe_ffn``
against ``repro.models.moe.moe_ffn(..., None)`` on the smoke configs of both
MoE architectures, with the same (JAX-initialised) weights and the same
numpy inputs: the output and the Switch aux loss, with and without capacity
drops.

Tolerances: 1e-5 in f32 (the same products, summed in another order); 2e-2
with bf16 compute (the expert products and the SiLU gate are rounded to bf16
in both packages, at other points of the sum).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def configs(arch, **overrides):
    return (dataclasses.replace(jax_get_config(arch).smoke(), **overrides),
            dataclasses.replace(get_config(arch).smoke(), **overrides))


def moe_params(jcfg, seed=0):
    params, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(np.asarray, params)


def run_both(jcfg, tcfg, params, x, dtype):
    jx = jnp.asarray(x).astype(dtype)
    jout, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, params), jx, jcfg, None)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tout, taux = moe.moe_ffn(tparams, tx, tcfg)
    return (tout, taux), (jout, jaux)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def expert_loads(x, router, top_k):
    """Assignments each expert gets (top-k of the f32 gates)."""
    gates = x.reshape(-1, x.shape[-1]).astype(np.float32) @ router
    top = np.argsort(-gates, axis=-1, kind="stable")[:, :top_k]
    return np.bincount(top.reshape(-1), minlength=router.shape[1])


@pytest.mark.parametrize("capacity_factor", [4.0, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_moe_ffn_matches_jax(arch, dtype, capacity_factor):
    jcfg, tcfg = configs(arch, compute_dtype=dtype, capacity_factor=capacity_factor)
    params = moe_params(jcfg)
    x = np.random.default_rng(1).standard_normal((2, 32, jcfg.d_model), dtype=np.float32)
    C = moe.capacity(64, tcfg)
    assert C == max(int(64 * tcfg.top_k / tcfg.n_experts * capacity_factor), 4)
    loads = expert_loads(x, params["router"], tcfg.top_k)
    if capacity_factor == 1.0:
        assert loads.max() > C, "this case must drop assignments"
    else:
        assert loads.max() <= C, "this case must drop none"
    (tout, taux), (jout, jaux) = run_both(jcfg, tcfg, params, x, dtype)
    assert tout.dtype == getattr(torch, dtype) and tout.shape == x.shape
    assert taux.dtype == torch.float32 and taux.shape == ()
    tol = TOL[dtype]
    np.testing.assert_allclose(as_np(tout), as_np(jout), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-6)


def test_moe_capacity_keeps_the_first_tokens_of_an_expert():
    """Every token routes to experts 0 and 1 first: of each expert's 40
    assignments only the first C = 10 in token order get a slot, so tokens
    past them get no expert output at all, in both packages."""
    jcfg, tcfg = configs("mixtral-8x7b", capacity_factor=0.5)
    params = moe_params(jcfg)
    d, E = jcfg.d_model, jcfg.n_experts
    router = np.zeros((d, E), np.float32)
    router[0] = [3.0, 2.0, 1.0, 0.0][:E]  # gates ordered by expert id for x[..., 0] > 0
    params["router"] = router
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 40, d), dtype=np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 0.5
    C = moe.capacity(40, tcfg)
    assert C == 10
    (tout, _), (jout, _) = run_both(jcfg, tcfg, params, x, "float32")
    np.testing.assert_allclose(as_np(tout), as_np(jout), rtol=1e-5, atol=1e-5)
    out = as_np(tout)[0]
    assert np.abs(out[:C]).min() > 0
    np.testing.assert_array_equal(out[C:], 0.0)


def test_expert_parallel_takes_this_ranks_experts():
    """Under an axis_info the layer takes this rank's shard and refuses the
    whole expert stack; on a mesh of one rank its shard is every expert and
    the layer is the single-device one, bit for bit. Across ranks:
    tests/test_torch_sharded_decode.py."""
    from repro_torch.parallel.axisinfo import AxisInfo, Mesh
    from repro_torch.parallel.sharding import shard_params

    _, tcfg = configs("mixtral-8x7b")
    params = moe.moe_init(torch.Generator().manual_seed(0), tcfg)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, tcfg.d_model), dtype=np.float32))
    one = AxisInfo(Mesh((1, 1), ("data", "model")), ("data",))
    local = shard_params({"blocks": {"ffn": {k: v[None] for k, v in params.items()}}}, tcfg, one)
    local = {k: v[0] for k, v in local["blocks"]["ffn"].items()}
    got, aux = moe.moe_ffn(local, x, tcfg, one)
    want, want_aux = moe.moe_ffn(params, x, tcfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(aux, want_aux, rtol=0, atol=0)
    two = AxisInfo(Mesh((1, 2), ("data", "model")), ("data",))
    with pytest.raises(ValueError, match="shard"):
        moe.moe_ffn(params, x, tcfg, two)
    assert moe.use_expert_parallel(tcfg, 2) and not moe.use_expert_parallel(
        dataclasses.replace(tcfg, n_experts=3), 2)
    with pytest.raises(ValueError, match="divide"):
        moe.use_expert_parallel(dataclasses.replace(tcfg, n_experts=3, d_ff=127), 2)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("capacity_factor", [4.0, 1.0])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_chip_smoke_moe_loop_matches_jax(arch, capacity_factor):
    """chip_smoke.py holds the port's MoE layer at full width to its own f32
    loop (moe_plain); that loop, its capacity and its drop rule included,
    is the JAX layer's in f32, dropped assignments counted."""
    jcfg, tcfg = configs(arch, compute_dtype="float32", capacity_factor=capacity_factor)
    params = moe_params(jcfg)
    x = np.random.default_rng(1).standard_normal((2, 32, jcfg.d_model), dtype=np.float32)
    loads = expert_loads(x, params["router"], tcfg.top_k)
    C = moe.capacity(64, tcfg)
    jout, _ = jmoe.moe_ffn(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg, None)
    t = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    out, dropped = _chip_smoke().moe_plain(torch.from_numpy(x).reshape(64, -1), t["router"], t["w1"],
                                           t["wg"], t["w2"], tcfg)
    assert dropped == int(np.maximum(loads - C, 0).sum())
    assert (dropped > 0) == (capacity_factor == 1.0)
    np.testing.assert_allclose(out.numpy(), as_np(jout).reshape(64, -1), rtol=1e-5, atol=1e-5)
