"""The port's blob-store checkpointer (``repro_torch.storage.checkpoint``)
and token pipeline (``repro_torch.data.pipeline``, a verbatim copy) against
the JAX package's, on the CPU: the same leaf paths, page layout and blob
bytes for the same training state (f32 and bf16 params), the same batches
from the same corpus, and the launcher's corpus token for token; then the
ports of tests/test_storage.py's checkpointer tests on torch tensors."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.data.pipeline import write_token_corpus as jax_write_token_corpus  # noqa: E402
from repro.models.lm import build_model as jax_build_model  # noqa: E402
from repro.storage.checkpoint import BlobCheckpointer as JBlobCheckpointer  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline, write_token_corpus  # noqa: E402
from repro_torch.launch.train import bigram_corpus, corpus_tokens  # noqa: E402
from repro_torch.parallel.axisinfo import AxisInfo, Mesh  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402
from repro_torch.storage.checkpoint import BlobCheckpointer  # noqa: E402


def session_of(core):
    return core.Cluster(n_data_providers=4, n_metadata_providers=4, shared_cache_bytes=0)


@pytest.fixture
def session():
    cluster = session_of(tcore)
    try:
        yield cluster.session()
    finally:
        cluster.close()


def jax_state(param_dtype):
    jcfg = dataclasses.replace(jax_get_config("llama3_2-1b").smoke(), param_dtype=param_dtype)
    tcfg = dataclasses.replace(get_config("llama3_2-1b").smoke(), param_dtype=param_dtype)
    model = jax_build_model(jcfg)
    params = jax.jit(lambda key: model.init(key)[0])(jax.random.PRNGKey(0))
    opt = jax_adamw_init(params)
    opt = dict(opt, step=jnp.int32(7), m=jax.tree.map(lambda p: jnp.full(p.shape, 0.5, jnp.float32), params))
    state_np = {"params": jax.tree.map(np.asarray, params), "opt": jax.tree.map(np.asarray, opt)}
    port = {"params": params_from_jax(state_np["params"], tcfg, "cpu"),
            "opt": opt_state_from_jax(state_np["opt"], tcfg, "cpu")}
    return state_np, port


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_layout_and_bytes_equal_the_jax_checkpointers(param_dtype):
    """Leaf paths, offsets, sizes, dtype names and shapes equal; the blob a
    save writes holds the same bytes (bf16 params as their uint16 bits)."""
    state_np, port = jax_state(param_dtype)
    blobs = []
    for core, cls, state in ((jcore, JBlobCheckpointer, state_np), (tcore, BlobCheckpointer, port)):
        cluster = session_of(core)
        try:
            ck = cls(cluster.session(), state, page_size=4096)
            rec = ck.save(0, state)
            blobs.append((ck.layout, (rec.dirty_pages, rec.total_pages),
                          ck.handle.read(0, ck.blob_bytes, version=rec.version).data.tobytes()))
        finally:
            cluster.close()
    (jlayout, jrec, jbytes), (layout, rec, raw) = blobs
    assert [dataclasses.astuple(x) for x in layout] == [dataclasses.astuple(x) for x in jlayout]
    assert layout[-1].path == "['params']['ln_f']" and layout[0].path.startswith("['opt']['m']['blocks']")
    assert any(x.dtype == "bfloat16" for x in layout) == (param_dtype == "bfloat16")
    assert rec == jrec and raw == jbytes


def test_restore_gives_the_saved_tensors_on_the_device(session):
    _, port = jax_state("bfloat16")
    ck = BlobCheckpointer(session, port, page_size=4096)
    ck.save(3, port)
    out = ck.restore(device="cpu")
    want, got = jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(out)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    # onto a mesh: a spec tree like the state; rank 1 of a (data 2, model 1)
    # mesh keeps its half of a leaf split over "data" (no process group: this
    # process reads the blob itself)
    ai = AxisInfo(Mesh((2, 1), ("data", "model"), rank=1), batch_axes=("data",))
    specs = jax.tree_util.tree_map(lambda _: P(), port)
    specs["params"]["embed"]["table"] = P("data")
    on_mesh = ck.restore(device="cpu", shardings=specs, axis_info=ai)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(on_mesh), jax.tree_util.tree_leaves(port)):
        if jax.tree_util.keystr(path) == "['params']['embed']['table']":
            b = b[b.shape[0] // 2:]
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(device="cpu", shardings={"params": P()}, axis_info=ai)


# ------------------------------ ports of tests/test_storage.py ------------------------------
def _tiny_state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "w1": torch.randn((64, 64), generator=gen),
        "w2": torch.zeros((32,)),
        "step": torch.tensor(0, dtype=torch.int32),
    }


def _leaves(state):
    return [state[k] for k in sorted(state)]


def test_checkpoint_roundtrip(session):
    state = _tiny_state()
    ck = BlobCheckpointer(session, state, page_size=4096)
    rec = ck.save(0, state)
    assert rec.dirty_pages > 0
    out = ck.restore(0, device="cpu")
    for a, b in zip(_leaves(out), _leaves(state)):
        assert torch.equal(a, b)


def test_incremental_checkpoint_writes_only_dirty_pages(session):
    state = _tiny_state()
    ck = BlobCheckpointer(session, state, page_size=4096)
    r0 = ck.save(0, state)
    r1 = ck.save(1, state)  # identical state -> zero dirty pages (pure COW sharing)
    assert r1.dirty_pages == 0
    r2 = ck.save(2, dict(state, w2=state["w2"] + 1.0))  # one leaf touched -> only its page
    assert 0 < r2.dirty_pages < r0.dirty_pages
    assert float(ck.restore(1, device="cpu")["w2"][0]) + 1.0 == float(ck.restore(2, device="cpu")["w2"][0])


def test_checkpoint_crash_consistency(session):
    """A checkpoint is visible only once complete: a reader pinned to step 0
    while step 1 is saved in the background reads step 0's state."""
    state = _tiny_state()
    ck = BlobCheckpointer(session, state, page_size=4096)
    ck.save(0, state)
    before = ck.restore(0, device="cpu")
    state2 = {k: v + 1 if v.dtype != torch.int32 else v for k, v in state.items()}
    t = ck.save_async(1, state2)
    state2["w1"].zero_()  # the snapshot was taken before the call returned
    got = ck.restore(0, device="cpu")
    for a, b in zip(_leaves(got), _leaves(before)):
        assert torch.equal(a, b)
    t.join(timeout=60)
    assert not t.is_alive()
    assert torch.equal(ck.restore(1, device="cpu")["w1"], state["w1"] + 1)


def test_checkpoint_gc_retention(session):
    state = _tiny_state()
    ck = BlobCheckpointer(session, state, page_size=4096, keep_last=2)
    for i in range(5):
        state = dict(state, w1=state["w1"] + 1.0)
        ck.save(i, state)
    assert [c.step for c in ck.checkpoints] == [3, 4]
    assert torch.equal(ck.restore(4, device="cpu")["w1"], state["w1"])
    ck.restore(3, device="cpu")


# ------------------------------ the token pipeline ------------------------------
def test_pipeline_batches_equal_the_jax_pipelines():
    n_tokens = corpus_tokens(4, 32)
    corpus = np.random.default_rng(5).integers(0, 1000, n_tokens, dtype=np.int32)
    jcluster, tcluster = session_of(jcore), session_of(tcore)
    try:
        jpipe = JTokenPipeline(jax_write_token_corpus(jcluster.session(), corpus), n_tokens,
                               JPipelineConfig(batch_per_rank=4, seq_len=32, n_ranks=2, rank=1, seed=3))
        pipe = TokenPipeline(write_token_corpus(tcluster.session(), corpus), n_tokens,
                             PipelineConfig(batch_per_rank=4, seq_len=32, n_ranks=2, rank=1, seed=3))
        for step in (0, 1, 7):
            want, got = jpipe.batch_at(step), pipe.batch_at(step)
            assert sorted(got) == ["labels", "tokens"]
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        jcluster.close()
        tcluster.close()


def test_bigram_corpus_is_the_jax_launchers():
    """The JAX launcher's loop over numpy scalars, as the reference."""
    vocab, n_tokens, seed = 512, 5000, 3
    rng = np.random.default_rng(seed)
    want = np.empty(n_tokens, dtype=np.int32)
    want[0] = 1
    nxt = (np.arange(vocab, dtype=np.int64) * 31 + 7) % vocab
    noise = rng.random(n_tokens) < 0.1
    rand_toks = rng.integers(0, vocab, n_tokens)
    for i in range(1, n_tokens):
        want[i] = rand_toks[i] if noise[i] else nxt[want[i - 1]]
    got = bigram_corpus(vocab, n_tokens, np.random.default_rng(seed))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
