"""The port's mesh, sharding rules and collectives vs the JAX package.

* ``logical_rules``, ``param_shardings``, ``cache_shardings`` and
  ``param_axes`` equal the JAX package's for every config's smoke model on
  ``(data 2, model 2)`` and ``(pod 2, data 2, model 2)`` meshes, and
  ``page_offset_in_shard`` equals JAX's inside ``shard_map``. The JAX side
  needs 8 host devices, which must be forced before JAX is imported, so it
  runs in a subprocess (``_jax_layouts``) with a deadline.
* The split-K combine across 2 and 4 ranks (spawned processes over gloo on
  the CPU, a ``FileStore`` in a fresh directory, a 60 s deadline each)
  equals ``repro.kernels.ref.online_softmax_combine`` of the JAX package's
  ``_paged_local_xla`` shard partials, with a rank that owns no valid page
  and a row with no token at all; the collectives themselves over every
  group of a (2, 2) mesh.

JAX is imported inside the functions that use it: the spawned ranks import
this module and run only the port.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import param_shapes  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models.lm import build_model, param_axes  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.axisinfo import AxisInfo, Mesh, page_offset_in_shard  # noqa: E402

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
DEADLINE_S = 60.0
MESHES = {"2x2": ((2, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
OFFSET_AXES = (("data", "model"), ("model", "data"), ("model",), ("pod", "data", "model"))


def run_jax(code: str, devices: int, timeout: float = DEADLINE_S) -> None:
    """Run ``code`` in a fresh Python with ``devices`` forced host devices
    and this directory importable; fails the test on error or deadline."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]


def norm(x):
    """Specs and axes as plain nested lists for JSON: tuples become lists."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [norm(v) for v in x]
    return x


def _cache_cases(arch):
    """(batch, seq_len, pad) of the caches whose shardings are compared: one
    padded to the page shards, one whose pool divides neither mesh."""
    T = get_config(arch).smoke().kv_page_tokens
    return {"padded": (4, 4 * T, None), "odd": (3, 5 * T, 1)}


def _jax_layouts(out_path: str) -> None:
    """JAX side: every smoke config's rules, axes, param and cache specs on
    both meshes, and page offsets inside ``shard_map``; written as JSON."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_config as jget
    from repro.launch.mesh import make_axis_info
    from repro.models.lm import build_model as jbuild
    from repro.parallel import sharding as jshd
    from repro.parallel.axisinfo import page_offset_in_shard as joffset
    from repro.parallel.compat import shard_map

    out = {"archs": {}, "offsets": {}}
    for mname, (shape, names) in MESHES.items():
        mesh = jax.make_mesh(shape, names)
        ai = make_axis_info(mesh)
        for axes in OFFSET_AXES:
            if not set(axes) <= set(names):
                continue
            f = shard_map(lambda x, axes=axes: x + joffset(axes, 5), mesh=mesh, in_specs=JP(axes),
                          out_specs=JP(axes), check_vma=False)
            out["offsets"][f"{mname}:{','.join(axes)}"] = np.asarray(f(jnp.zeros(mesh.size, jnp.int32))).tolist()
        for arch in ARCH_IDS:
            cfg = jget(arch).smoke()
            model = jbuild(cfg)
            box = {}

            def init(key, model=model, box=box):
                params, box["axes"] = model.init(key)
                return params

            params = jax.eval_shape(init, jax.random.PRNGKey(0))
            rec = out["archs"].setdefault(arch, {})
            rec["axes"] = norm(box["axes"])
            got = {"rules": norm(jshd.logical_rules(cfg, ai)),
                   "params": norm(jax.tree.map(lambda s: tuple(s.spec),
                                               jshd.param_shardings(params, box["axes"], cfg, ai)))}
            for case, (b, s, pad) in _cache_cases(arch).items():
                cache = jax.eval_shape(lambda b=b, s=s, pad=pad: model.init_cache(b, s, pad or ai.n_page_shards))
                got[f"cache_{case}"] = norm(jax.tree.map(lambda s: tuple(s.spec),
                                                         jshd.cache_shardings(cache, cfg, ai)))
            rec[mname] = got
    Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def jax_layouts(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_layouts") / "layouts.json"
    run_jax(f"import test_torch_parallel as t; t._jax_layouts({str(path)!r})", devices=8)
    return json.loads(path.read_text())


def mesh_info(mname: str, rank: int = 0) -> AxisInfo:
    shape, names = MESHES[mname]
    return launch_mesh.make_axis_info(Mesh(shape, names, rank=rank))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layouts_equal_jax(arch, jax_layouts):
    """Rules, the logical axes tree, the param specs and the cache specs
    (padded and not) of each smoke config, on both meshes."""
    cfg = get_config(arch).smoke()
    want = jax_layouts["archs"][arch]
    assert norm(param_axes(cfg)) == want["axes"]
    model = build_model(cfg)
    for mname in MESHES:
        ai = mesh_info(mname)
        assert norm(shd.logical_rules(cfg, ai)) == want[mname]["rules"]
        got = shd.param_shardings(param_shapes(cfg), param_axes(cfg), cfg, ai)
        assert norm(got) == want[mname]["params"], mname
        for case, (b, s, pad) in _cache_cases(arch).items():
            cache = model.init_cache(b, s, device="cpu", pad_pages_to=pad or ai.n_page_shards)
            assert norm(shd.cache_shardings(cache, cfg, ai)) == want[mname][f"cache_{case}"], (mname, case)


def test_page_offset_in_shard_equals_jax(jax_layouts):
    """Each rank's first global page (pages_local 5) over several axis
    tuples and orders, rank by rank in JAX's device order."""
    for key, want in jax_layouts["offsets"].items():
        mname, axes = key.split(":")
        shape, names = MESHES[mname]
        axes = tuple(axes.split(","))
        n = int(np.prod(shape))
        # JAX's output block i belongs to the device at row-major index i
        # over ``axes``; each rank's offset lands at that index
        got = [None] * n
        for r in range(n):
            m = Mesh(shape, names, rank=r)
            i = m.axes_index(axes)
            blk = n // m.axes_size(axes)
            for j in range(blk):
                got[i * blk + j] = page_offset_in_shard(axes, 5, m)
        assert got == want, key


def test_shard_leaf_blocks_tile_the_value():
    """Every rank's block, put back in rank order, is the value; a spec over
    two axes takes row-major blocks in the order given."""
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    for spec in (shd.P(None, ("data", "model")), shd.P(None, ("model", "data")), shd.P("data", "model")):
        blocks = {}
        for r in range(4):
            ai = mesh_info("2x2", rank=r)
            blocks[tuple(ai.mesh.coords().values())] = shd.shard_leaf(x, spec, ai)
        if spec[0] is None:
            order = [(d, m) for d in range(2) for m in range(2)]
            if spec[1] == ("model", "data"):
                order = [(d, m) for m in range(2) for d in range(2)]
            torch.testing.assert_close(torch.cat([blocks[c] for c in order], dim=1), x, rtol=0, atol=0)
        else:
            rows = [torch.cat([blocks[(d, m)] for m in range(2)], dim=1) for d in range(2)]
            torch.testing.assert_close(torch.cat(rows, dim=0), x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="divide"):
        shd.shard_leaf(torch.zeros(6, 3), shd.P(("data", "model")), mesh_info("2x2"))


def test_shard_params_keeps_this_ranks_experts():
    """EP (experts divide the model axis): each rank's experts; expert-TP
    (3 experts on 2 ranks): each rank's ffn columns of every expert;
    everything else the same tensor."""
    for n_experts, ep in ((4, True), (3, False)):
        cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke(), n_experts=n_experts)
        params = build_model(cfg).init(seed=0, device="cpu")
        for r in range(4):
            ai = mesh_info("2x2", rank=r)
            local = shd.shard_params(params, cfg, ai)
            m = ai.mesh.coords()["model"]
            for name in ("w1", "wg", "w2"):
                full, got = params["blocks"]["ffn"][name], local["blocks"]["ffn"][name]
                if ep:
                    want = full[:, m * 2:(m + 1) * 2]
                elif name == "w2":
                    want = full[:, :, m * 64:(m + 1) * 64]
                else:
                    want = full[:, :, :, m * 64:(m + 1) * 64]
                torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert local["blocks"]["ffn"]["router"] is params["blocks"]["ffn"]["router"]
            assert local["blocks"]["attn"]["wq"] is params["blocks"]["attn"]["wq"]


def test_shard_cache_pads_and_stripes_the_pools():
    """Pools and int8 scales padded to the page shards and striped (copies);
    tables, page_pos and lengths untouched."""
    cfg = get_config("mistral-large-123b").smoke()
    cache = build_model(cfg).init_cache(3, 5 * cfg.kv_page_tokens, device="cpu")
    n_pages = cache["kv"]["pool_k"].shape[1]
    assert n_pages % 4
    for r in range(4):
        ai = mesh_info("2x2", rank=r)
        local = shd.shard_cache(cache, cfg, ai)
        for name in shd.POOL_LEAVES:
            assert local["kv"][name].shape[1] == -(-n_pages // 4)
        assert local["kv"]["tables"] is cache["kv"]["tables"] and local["lengths"] is cache["lengths"]


def test_shard_cache_takes_the_ranks_rows_of_the_ssm_states():
    """``cache_shardings``' blocks of a hybrid cache: the states' rows over
    ``data`` (copies) where the batch divides, every row where it does not;
    the pools striped."""
    cfg = get_config("zamba2-2.7b").smoke()
    model = build_model(cfg)
    for batch in (4, 3):
        cache = model.init_cache(batch, 4 * cfg.kv_page_tokens, device="cpu")
        for name in shd.STATE_LEAVES:
            cache["ssm"][name].normal_(generator=torch.Generator().manual_seed(batch))
        for r in range(4):
            ai = mesh_info("2x2", rank=r)
            local = shd.shard_cache(cache, cfg, ai)
            rows = shd.row_block(batch, ai)
            assert (rows.stop - rows.start) == (batch // 2 if batch % 2 == 0 else batch)
            for name in shd.STATE_LEAVES:
                want = cache["ssm"][name][:, rows]
                assert torch.equal(local["ssm"][name], want)
                if batch % 2 == 0:
                    assert local["ssm"][name].data_ptr() != want.data_ptr()
            assert local["kv"]["pool_k"].shape[1] == -(-cache["kv"]["pool_k"].shape[1] // 4)


@pytest.mark.parametrize("arch", ["llama3_2-1b", "mistral-large-123b", "mamba2-370m", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_init_cache_with_an_axis_info_is_the_shard_of_the_whole(arch):
    """``init_cache(axis_info=)`` allocates what ``shard_cache`` of the
    whole empty cache keeps on each rank (the pools' stripe, the states'
    rows, every other leaf whole), leaf for leaf, shape, dtype and values,
    with and without padding, with batches that divide and that do not."""
    cfg = get_config(arch).smoke()
    model = build_model(cfg)
    T = cfg.kv_page_tokens
    for batch, seq, pad in ((4, 4 * T, 1), (3, 5 * T, 3)):
        whole = model.init_cache(batch, seq, device="cpu", pad_pages_to=pad)
        for mname in MESHES:
            for r in range(int(np.prod(MESHES[mname][0]))):
                ai = mesh_info(mname, rank=r)
                want = shd.shard_cache(whole, cfg, ai)
                got = model.init_cache(batch, seq, device="cpu", pad_pages_to=pad, axis_info=ai)
                flat = {}
                shd._map(lambda path, a, b: flat.__setitem__(path, (a, b)), got, want)
                assert flat
                for path, (a, b) in flat.items():
                    assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), (mname, r, path)


def _spec_rank(ai, chosen, spec):
    return {"spec": spec, "built": shd.P(None, ai.batch_axes),
            "specs": shd.jax_specs(get_config("llama3_2-1b").smoke(), ai)}


def test_partition_specs_survive_pickle_save_and_spawn():
    """A spec round-trips through ``pickle`` and ``torch.save``/``torch.load``
    as itself (a ``P``, entries unchanged), and so do the specs two spawned
    ranks return through ``launch.mesh.spawn``."""
    import io
    import pickle

    specs = (shd.P(None, "data"), shd.P(), shd.P("data"), shd.P(("pod", "data"), "model"), shd.P(None, None, "model"))
    for spec in specs:
        buf = io.BytesIO()
        torch.save({"s": spec}, buf)
        buf.seek(0)
        for back in (pickle.loads(pickle.dumps(spec)), torch.load(buf, weights_only=False)["s"]):
            assert type(back) is shd.P and back == spec and tuple(back) == tuple(spec)
    res = launch_mesh.spawn(_spec_rank, 2, (shd.P(None, "data"),), device="cpu", timeout_s=DEADLINE_S)
    want = shd.jax_specs(get_config("llama3_2-1b").smoke(), launch_mesh.make_axis_info(Mesh((2, 1), ("data", "model"))))
    for r in res:
        assert type(r["spec"]) is shd.P and r["spec"] == shd.P(None, "data") and r["built"] == shd.P(None, "data")
        flat = []
        shd._map(lambda _, a, b: flat.append(type(a) is shd.P and a == b), r["specs"], want)
        assert flat and all(flat)


def test_meshes_without_a_process_group():
    """One process and no group: the elastic mesh is (1, 1); the production
    meshes need 256 or 512 ranks; ``P`` normalises one-name tuples as
    JAX's PartitionSpec does; the backend is gloo only when asked for the
    CPU."""
    mesh = launch_mesh.make_mesh_for_devices()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {}
    ai = launch_mesh.make_axis_info(mesh)
    assert ai.page_axes == ("data", "model") and ai.n_page_shards == 1
    assert collectives.psum(torch.ones(2), ai.page_axes, mesh).tolist() == [1.0, 1.0]
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            launch_mesh.make_production_mesh(multi_pod=multi_pod)
    assert shd.P(None, ("data",)) == (None, "data") and ai.sharding(("data", "model")) == (("data", "model"),)
    assert launch_mesh.choose_backend(4, 1, "cpu").backend == "gloo"
    with pytest.raises(RuntimeError, match="group"):
        Mesh((2, 2), ("data", "model")).group(("model",))


def test_sharded_training_raises():
    """Every non-MoE family's ``train_loss`` under an axis_info of a
    (data 2, model 2) mesh (no collective runs: only a MoE's do) computes
    on the rank's rows of the global batch (on every row, when the rows do
    not divide over the data axis); the model ranks' shares are equal, and
    the data ranks' shares of the loss and metrics sum to the
    single-device values, their gradients to its gradients."""
    rng = np.random.default_rng(0)
    for arch in ("llama3_2-1b", "mamba2-370m", "zamba2-2.7b", "seamless-m4t-medium"):
        cfg = get_config(arch).smoke()
        model = build_model(cfg)
        params = model.init(0, "cpu")
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))),
                 "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))}
        batch["labels"][1, :9] = -1
        if cfg.family in ("encdec", "audio"):
            batch["enc_embeds"] = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model), dtype=np.float32))
        leaves = [params["embed"]["table"]]

        def run(axis_info, batch):
            p = dict(params, embed={"table": leaves[0].detach().requires_grad_(True)})
            loss, metrics = model.train_loss(p, batch, axis_info=axis_info)
            return loss.detach(), metrics, torch.autograd.grad(loss, p["embed"]["table"])[0]

        for rows in (4, 3):  # 3 rows do not divide over the data axis: every rank takes half of all
            part = {k: v[:rows] for k, v in batch.items()}
            want = run(None, part)
            shares = [run(mesh_info("2x2", rank), part) for rank in range(4)]
            for a, b in ((0, 1), (2, 3)):
                assert torch.equal(shares[a][0], shares[b][0]) and torch.equal(shares[a][2], shares[b][2])
            torch.testing.assert_close(shares[0][0] + shares[2][0], want[0], rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(shares[0][2] + shares[2][2], want[2], rtol=1e-6, atol=1e-6)
            for k in want[1]:
                torch.testing.assert_close(shares[0][1][k] + shares[2][1][k], want[1][k], rtol=1e-6, atol=1e-6)


# ------------------------------ collectives across spawned ranks ------------------------------
def _collectives_rank(ai, chosen):
    mesh = ai.mesh
    r = mesh.rank
    x = torch.tensor([float(r), -float(r), 1.0])
    out = {"backend": chosen.backend}
    for axes in mesh.axis_subsets():
        key = ",".join(axes)
        out[f"psum:{key}"] = collectives.psum(x, axes, mesh)
        out[f"pmax:{key}"] = collectives.pmax(x, axes, mesh)
        out[f"pmean:{key}"] = collectives.pmean(x, axes, mesh)
        out[f"index:{key}"] = collectives.axis_index(axes, mesh)
    block = torch.full((2, 3), float(r))
    out["regather"] = collectives.regather(block, ("data",), mesh, sum_names=("model",))
    out["x"] = x
    out["stats"] = dict(collectives.stats)
    return out


def test_collectives_over_every_group():
    """psum/pmax/pmean over each axis tuple of a (2, 2) mesh equal numpy over
    the ranks of that group; the input is not modified; regather is the
    gather over data of the sum over model."""
    res = launch_mesh.spawn(_collectives_rank, 4, model_parallel=2, device="cpu", timeout_s=DEADLINE_S)
    mesh = Mesh((2, 2), ("data", "model"))
    xs = {r: np.array([r, -r, 1.0], np.float32) for r in range(4)}
    for r, got in enumerate(res):
        assert got["backend"] == "gloo"
        np.testing.assert_array_equal(got["x"].numpy(), xs[r])
        for axes in mesh.axis_subsets():
            key = ",".join(axes)
            group = next(g for g in mesh.group_ranks(axes) if r in g)
            vals = np.stack([xs[q] for q in group])
            np.testing.assert_array_equal(got[f"psum:{key}"].numpy(), vals.sum(0))
            np.testing.assert_array_equal(got[f"pmax:{key}"].numpy(), vals.max(0))
            np.testing.assert_allclose(got[f"pmean:{key}"].numpy(), vals.mean(0), rtol=1e-7)
            assert got[f"index:{key}"] == Mesh((2, 2), ("data", "model"), rank=r).axes_index(axes)
        # rank r = 2 * data + model: the data block d holds 2d + (2d + 1)
        want = np.concatenate([np.full((2, 3), 4 * d + 1.0) for d in range(2)])
        np.testing.assert_array_equal(got["regather"].numpy(), want)
        assert got["stats"]["calls"] == 3 * 3 + 1  # pmean is one psum
    assert len({tuple(g["regather"].flatten().tolist()) for g in res}) == 1


# ------------------------------ the split-K combine ------------------------------
B, R, T, K, H, D = 3, 3, 8, 2, 4, 16
LENGTHS = np.array([24, 0, 13], np.int32)  # row 1 holds no token at all


def combine_case(seed: int = 0):
    """12 pool pages, 9 referenced; rows straddle ranks. With 4 ranks of 3
    pages, rank 2 holds only row 1's pages (no token: an empty shard for
    every row); with 2 ranks of 6, rows 0 and 2 have valid pages on both.
    Row 2's third page lies past its length; pages 2, 3 and 11 are free."""
    rng = np.random.default_rng(seed)
    P = 12
    tables = np.array([[0, 9, 4], [6, 7, 8], [10, 1, 5]], np.int32)
    page_pos = np.tile(np.arange(R, dtype=np.int32) * T, (B, 1))
    pool_k = rng.standard_normal((P, T, K, D), dtype=np.float32)
    pool_v = rng.standard_normal((P, T, K, D), dtype=np.float32)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    return q, pool_k, pool_v, tables, page_pos


def _combine_rank(ai, chosen, case, impl):
    q, pool_k, pool_v, tables, page_pos = (torch.from_numpy(a) for a in case)
    n = ai.n_page_shards
    pl = pool_k.shape[0] // n
    off = page_offset_in_shard(ai.page_axes, pl, ai.mesh)
    local = slice(off, off + pl)
    out = ops.paged_attention(q, pool_k[local], pool_v[local], tables, page_pos, torch.from_numpy(LENGTHS),
                              page_offset=off, axis_names=ai.page_axes, mesh=ai.mesh, impl=impl)
    partial = ops.paged_attention_plain(q, pool_k[local], pool_v[local], tables, page_pos,
                                        torch.from_numpy(LENGTHS), page_offset=off)
    return {"out": out, "m": partial[1], "offset": off}


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_combine_across_ranks_matches_jax(n_ranks):
    """Each rank's kernel-path (plain on the CPU) and ``impl="ref"`` results
    equal JAX's combine of its shard partials within 3e-5 (f32 partials
    summed in another order: tests/test_kernels.py's tolerance), are
    bit-equal across ranks, and the empty row is exactly 0."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    case = combine_case()
    q, pool_k, pool_v, tables, page_pos = case
    P = pool_k.shape[0]
    pl = P // n_ranks
    parts = [jops._paged_local_xla(jnp.asarray(q), jnp.asarray(pool_k[o:o + pl]), jnp.asarray(pool_v[o:o + pl]),
                                   jnp.asarray(tables), jnp.asarray(page_pos), jnp.asarray(LENGTHS), window=None,
                                   page_offset=o, n_pages_total=P)
             for o in range(0, P, pl)]
    want = np.asarray(jref.online_softmax_combine(*(jnp.stack([p[i] for p in parts]) for i in range(3))))
    if n_ranks == 4:  # the last shard owns no valid page of any row
        assert (np.asarray(parts[-2][1]) == np.float32(-1e30)).all()
    for impl in (None, "ref"):
        res = launch_mesh.spawn(_combine_rank, n_ranks, (case, impl), model_parallel=2, device="cpu",
                                timeout_s=DEADLINE_S)
        assert [r["offset"] for r in res] == list(range(0, P, pl))
        for r in res:
            np.testing.assert_allclose(r["out"].numpy(), want, rtol=3e-5, atol=3e-5)
            assert torch.equal(r["out"], res[0]["out"])
            assert float(r["out"][1].abs().max()) == 0.0
        # the empty row is empty on every rank
        assert all((r["m"][1] == np.float32(-1e30)).all() for r in res)


@pytest.mark.parametrize("rows, global_rows", [(4, None), (2, 8), (3, 8), (8, None)])
def test_sharded_step_refuses_a_batch_that_is_not_the_ranks_rows(rows, global_rows):
    """Across batch shards the train step must be told the global batch's
    rows, and takes only this rank's block of them (or, where they do not
    divide, all of them): any other batch raises before a collective."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step

    cfg = get_config("llama3_2-1b").smoke()
    ai = mesh_info("2x2", 0)
    model = build_model(cfg)
    params = shd.shard_params(model.init(0, "cpu"), cfg, ai, layout="jax")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, 8))) for k in ("tokens", "labels")}
    step = make_train_step(model, cfg, opt.AdamWConfig(), axis_info=ai)
    with pytest.raises(ValueError, match="global_rows" if global_rows is None else "rows"):
        step(params, opt.adamw_init(params), batch, global_rows)
