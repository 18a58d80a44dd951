"""Blob mode of the port's serving engine against the JAX package's, on
``get_config("llama3_2-1b").smoke()`` with the same (JAX-initialised) weights.

The KV pool is a blob on a ``Cluster``; full prompt pages are published
versions that a second engine (own session, own device pool) resolves through
the cluster-wide ``PageDirectory`` and fetches instead of recomputing. The JAX
engine runs on its Pallas kernels in interpret mode (the ``pallas_interpret``
fixture of ``test_torch_serving.py``). Also held here: the port's copies of the
storage core are the JAX package's modules, and a page packs to the same bytes
in both packages, so pages cross between their stores and engines."""

import ast
import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.serving.blob_kv as jblob  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serving.blob_kv as tblob  # noqa: E402
from repro.analysis.lint import lint_paths as jax_lint_paths  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.analysis.lint import lint_paths  # noqa: E402
from repro_torch.launch.profile_serve import cell_requests  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, load_page, pack_page  # noqa: E402
from test_torch_serving import pallas_interpret, setup  # noqa: E402,F401 - fixtures

ROOT = Path(__file__).resolve().parents[1]

# each package: (core, blob_kv, engine class, request class)
JAX = (jcore, jblob, JEngine, JRequest)
PORT = (tcore, tblob, ServingEngine, Request)


def make_store(pkg, cfg, n_pages):
    core, blob, _, _ = pkg
    cluster = core.Cluster(n_data_providers=2, n_metadata_providers=2)
    store = blob.BlobKVStore.for_kv(
        cluster, n_pages=n_pages, page_tokens=cfg.kv_page_tokens, n_layers=cfg.n_layers,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        dtype=np.dtype("uint16" if cfg.kv_cache_dtype == "bfloat16" else cfg.kv_cache_dtype),  # bf16 as raw bytes
    )
    return cluster, store


def make_engine(pkg, setup, client, slots):
    jcfg, jparams, tcfg, tparams = setup
    if pkg is JAX:
        return JEngine(jcfg, jparams, max_slots=slots, kv_client=client)
    return ServingEngine(tcfg, tparams, max_slots=slots, kv_client=client, device="cpu")


def serve(pkg, engine, requests):
    for rid, prompt, n_new in requests:
        engine.submit(pkg[3](rid, list(prompt), max_new_tokens=n_new))
    return engine.run_until_drained()


PAGE = [5, 7, 11, 13, 17, 19, 23, 29]  # one full page (T=8)
SYSTEM = list(range(100, 116))  # a two-page shared system prompt

# (name, slots, pool pages, engine A's requests, engine B's requests,
# prompt tokens B must take from the directory), requests as
# (id, prompt, max_new_tokens). "two_engines" is tests/test_serving.py:112;
# "system_prompt" is chip_smoke.py's blob phase scaled down: more rows than
# slots behind one system prompt (batch COW forks), and B decodes past a page
# boundary (decode-page publishes).
CASES = [
    ("two_engines", 2, 64, [(0, PAGE + [31, 37, 41, 43, 47, 53, 59, 61], 4)],
     [(1, PAGE + [1, 2, 3, 4, 5, 6, 7, 8], 4)], len(PAGE)),
    ("system_prompt", 4, 128,
     [(i, SYSTEM + [200 + 8 * i + j for j in range(8)], 6) for i in range(6)],
     [(10 + i, SYSTEM + [300 + 8 * i + j for j in range(8)], 12) for i in range(6)], len(SYSTEM)),
]


def run_case(pkg, setup, case):
    _, slots, n_pages, reqs_a, reqs_b, _ = case
    cluster, store = make_store(pkg, setup[0], n_pages)
    try:
        engine_a = make_engine(pkg, setup, pkg[1].BlobKVClient(store), slots)
        done = serve(pkg, engine_a, reqs_a)
        used = store.used_slots
        engine_b = make_engine(pkg, setup, pkg[1].BlobKVClient(store), slots)
        done.update(serve(pkg, engine_b, reqs_b))
        return done, dict(store.stats), used, store.used_slots, engine_a.kv.stats, engine_b.kv.stats
    finally:
        cluster.close()


@pytest.mark.parametrize("case, kv_dtype", [(CASES[0], "bfloat16"), (CASES[1], "bfloat16"), (CASES[0], "float32")],
                         ids=["two_engines", "system_prompt", "two_engines_f32_pools"])
def test_blob_engine_tokens_match_jax_engine(setup, pallas_interpret, case, kv_dtype):
    jcfg, jparams, tcfg, tparams = setup
    setup = (dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype), jparams,
             dataclasses.replace(tcfg, kv_cache_dtype=kv_dtype), tparams)
    want, jstats, jused, jused_after, ja, jb = run_case(JAX, setup, case)
    assert pallas_interpret["flash_attention"] > 0 and pallas_interpret["paged_attention"] > 0
    got, tstats, used, used_after, ta, tb = run_case(PORT, setup, case)
    _, _, _, reqs_a, reqs_b, shared = case
    assert sorted(got) == sorted(want) == sorted(r[0] for r in reqs_a + reqs_b)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].prefill_skipped_tokens == want[rid].prefill_skipped_tokens, rid
    # B took the shared prompt pages from the directory, stored nothing twice
    assert all(got[r[0]].prefill_skipped_tokens == shared for r in reqs_b)
    assert tstats["prefix_hits"] >= len(reqs_b) * shared // len(PAGE)
    # only B's fresh full prompt pages persist (advertised in the directory)
    assert used_after <= used + sum((len(p) - shared) // len(PAGE) for _, p, _ in reqs_b)
    assert (tstats, used, used_after, ta, tb) == (jstats, jused, jused_after, ja, jb)


# ------------------------------ page bytes ------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("geometry", [(2, 8, 2, 16), (3, 8, 2, 16), (16, 64, 8, 64)],
                         ids=["smoke", "padded", "llama3_2-1b"])  # (L, T, K, hd)
def test_page_packs_to_the_same_bytes_as_jax(dtype, geometry):
    (L, T, K, hd), P = geometry, 5
    rng = np.random.default_rng(0)
    k32, v32 = (rng.standard_normal((L, P, T, K, hd)).astype(np.float32) for _ in range(2))
    jk, jv = (jnp.asarray(a).astype(dtype) for a in (k32, v32))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (k32, v32))
    nbytes = jblob.kv_page_nbytes(L, T, K, hd, jk.dtype)
    page_size = 1 << (nbytes - 1).bit_length()
    assert (page_size > nbytes) == (L == 3)
    if L == 16 and dtype == "bfloat16":
        assert page_size == nbytes == 2 ** 21  # one full-width page: 2 MiB, nothing padded
    for p in (0, 3):
        want = jblob.pack_kv_page(jk[:, p], jv[:, p], page_size)
        got = pack_page(tk[:, p], tv[:, p], page_size)
        assert got.dtype == np.uint8 and got.shape == (page_size,) and got.base is None
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tblob.pack_kv_page(np.asarray(jk[:, p]), np.asarray(jv[:, p]),
                                                         page_size), want)
        pool_k, pool_v = torch.zeros_like(tk), torch.zeros_like(tv)
        want.flags.writeable = False  # as a fetched page is
        load_page(pool_k, pool_v, p, want)
        assert torch.equal(pool_k[:, p], tk[:, p]) and torch.equal(pool_v[:, p], tv[:, p])
        assert not pool_k[:, p + 1].any()
        uk, uv = jblob.unpack_kv_page(want, (L, T, K, hd), jk.dtype)
        np.testing.assert_array_equal(np.asarray(uk, np.float32), pool_k[:, p].float().numpy())
        np.testing.assert_array_equal(np.asarray(uv, np.float32), pool_v[:, p].float().numpy())


def test_packed_page_is_a_copy_not_a_view_of_the_pool():
    pool = torch.ones((2, 3, 8, 2, 16), dtype=torch.bfloat16)
    buf = pack_page(pool[:, 1], pool[:, 1], 2 * pool[:, 1].numel() * 2)
    before = buf.copy()
    pool.zero_()  # later decode steps overwrite the pool
    np.testing.assert_array_equal(buf, before)


# --------------------------- pages across packages ---------------------------
def _cross(setup, store_pkg, publisher, reader):
    """The "two_engines" case on a store of ``store_pkg``: ``publisher``'s
    engine publishes the prefix page, ``reader``'s engine, with a
    ``store_pkg`` client (duck typing), takes it from the directory. Returns
    the reader's completion and client, and the publisher's and the reader's
    device-pool bytes of the shared page."""
    cluster, store = make_store(store_pkg, setup[0], 64)
    try:
        client = store_pkg[1].BlobKVClient
        eng_pub = make_engine(publisher, setup, client(store), 2)
        serve(publisher, eng_pub, CASES[0][3])
        eng_read = make_engine(reader, setup, client(store), 2)
        done = serve(reader, eng_read, CASES[0][4])
        slot = next(iter(eng_pub._resident))  # the prompt's first page
        assert eng_read._resident[slot] == eng_pub._resident[slot]
        page_bytes = [
            jblob.pack_kv_page(e.pool_k[:, slot], e.pool_v[:, slot], store.page_size)
            if isinstance(e, JEngine) else pack_page(e.pool_k[:, slot], e.pool_v[:, slot], store.page_size)
            for e in (eng_pub, eng_read)
        ]
        return done[1], eng_read.kv, page_bytes
    finally:
        cluster.close()


@pytest.mark.parametrize("store_pkg, reader", [(JAX, PORT), (PORT, JAX)], ids=["jax_store", "port_store"])
def test_pages_cross_between_packages(setup, pallas_interpret, store_pkg, reader):
    """A page that one package's engine published on its own package's
    store is read by the other package's engine, byte for byte, and decodes
    as the store's own package does."""
    got, client, (published, fetched) = _cross(setup, store_pkg, store_pkg, reader)
    want, _, _ = _cross(setup, store_pkg, store_pkg, store_pkg)
    assert isinstance(client, store_pkg[1].BlobKVClient)
    assert got.prefill_skipped_tokens == want.prefill_skipped_tokens == len(PAGE)
    assert got.tokens == want.tokens
    np.testing.assert_array_equal(fetched, published)


# ------------------------------ decode pages ------------------------------
def test_decode_page_publish_is_read_by_a_second_engine(setup):
    """A request that fills its second page while decoding publishes it
    through the async window; a second engine reads that page at its
    published version and gets the first engine's pool bytes."""
    cluster, store = make_store(PORT, setup[0], 32)
    try:
        eng_a = make_engine(PORT, setup, tblob.BlobKVClient(store), 2)
        eng_b = make_engine(PORT, setup, tblob.BlobKVClient(store), 2)
        kv, seen = eng_a.kv, []
        publish, finish = kv.publish_page_async, kv.finish

        def publish_page_async(seq, idx, payload):
            seen.append((idx, payload.copy()))
            publish(seq, idx, payload)

        def finish_and_read(seq):
            kv.drain_publishes(seq)
            addr = seq.page_addr[1]
            eng_b._load_shared_pages([(1, addr)])  # fetch into B's own device pool
            seen.append((addr, pack_page(eng_a.pool_k[:, addr.page], eng_a.pool_v[:, addr.page],
                                         store.page_size),
                         pack_page(eng_b.pool_k[:, addr.page], eng_b.pool_v[:, addr.page],
                                   store.page_size)))
            finish(seq)

        kv.publish_page_async, kv.finish = publish_page_async, finish_and_read
        done = serve(PORT, eng_a, [(0, PAGE, 12)])  # the 16th token fills page 1
        assert len(done[0].tokens) == 12
        (idx, payload), (addr, in_a, in_b) = seen
        assert idx == 1 and addr.version > 0 and eng_b._resident == {addr.page: addr.version}
        np.testing.assert_array_equal(payload, in_a)
        np.testing.assert_array_equal(in_b, in_a)
        assert kv.stats["published_pages"] == 2  # the prompt page, then the decode page
    finally:
        cluster.close()


# ------------------------------ backpressure ------------------------------
def test_blob_pool_exhaustion_requeues_and_drains(setup, pallas_interpret):
    """Four slots for five three-page prompts: while one request lives, the
    next admission finds the pool dry (the directory's pages are pinned by
    the live row) and is requeued; every request completes, as on the JAX
    engine."""
    reqs = [(i, [i + 1] * 20, 3) for i in range(5)]  # two full pages + a partial one each
    results = []
    for pkg in (JAX, PORT):
        cluster, store = make_store(pkg, setup[0], 4)
        try:
            client = pkg[1].BlobKVClient(store)
            admit, refused = client.admit, []

            def counted(tokens, admit=admit, refused=refused):
                try:
                    return admit(tokens)
                except MemoryError:
                    refused.append(tokens)
                    raise

            client.admit = counted
            done = serve(pkg, make_engine(pkg, setup, client, 2), reqs)
            results.append(({r: c.tokens for r, c in done.items()}, len(refused), dict(store.stats)))
        finally:
            cluster.close()
    (want, jrefused, jstats), (got, refused, stats) = results
    assert sorted(got) == list(range(5)) and got == want
    assert refused == jrefused > 0
    assert stats == jstats and stats["evictions"] > 0


# ------------------------------ the copied core ------------------------------
COPIED = ["analysis/lock_order.py", "analysis/lockwatch.py", "core/segment_tree.py",
          "core/version_manager.py", "core/dht.py", "core/provider.py", "core/page_cache.py",
          "core/page_directory.py", "core/prefetch.py", "core/repair.py",
          "core/replica_balancer.py", "core/cluster.py", "serving/blob_kv.py", "data/pipeline.py",
          "core/flat_view.py", "core/blob.py", "data/sky.py", "configs/paper_sky.py", "core/faults.py",
          "core/federation.py", "analysis/schedules.py", "analysis/lint.py"]
#: the functions (``Class.method``) in which a copy differs from its source: repairs of the
#: reference's faults (ROADMAP Queue 3)
REPAIRED = {"core/cluster.py": ["Cluster._gc_locked"],
            "core/federation.py": ["GcEpochCoordinator.__init__", "GcEpochCoordinator.end_sweep",
                                   "GcEpochCoordinator.sync_pins", "GcEpochCoordinator.unpin"]}


def _module_ast(package, module):
    text = (ROOT / "src" / package / module).read_text()
    return ast.parse(text.replace("repro_torch", "repro") if package == "repro_torch" else text)


def _take_out(tree, names):
    """Remove the named functions from ``tree`` (in place); returns each
    removed function's dump by name."""
    removed = {}

    def strip(body, prefix):
        kept = []
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and prefix + node.name in names:
                removed[prefix + node.name] = ast.dump(node)
                continue
            if isinstance(node, ast.ClassDef):
                node.body = strip(node.body, prefix + node.name + ".")
            kept.append(node)
        return kept

    tree.body = strip(tree.body, "")
    return removed


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_the_jax_package_module(module):
    """The copy is its source, apart from the functions ``REPAIRED`` names
    for it."""
    port, ref = _module_ast("repro_torch", module), _module_ast("repro", module)
    names = REPAIRED.get(module, [])
    port_fns, ref_fns = _take_out(port, names), _take_out(ref, names)
    assert ast.dump(port) == ast.dump(ref)
    assert sorted(port_fns) == sorted(ref_fns) == names


@pytest.mark.parametrize("module", sorted(REPAIRED))
def test_repaired_functions_differ_from_the_jax_package(module):
    port, ref = _module_ast("repro_torch", module), _module_ast("repro", module)
    port_fns, ref_fns = _take_out(port, REPAIRED[module]), _take_out(ref, REPAIRED[module])
    assert [name for name in REPAIRED[module] if port_fns[name] == ref_fns[name]] == []


def test_port_passes_the_concurrency_lint():
    assert lint_paths([str(ROOT / "src" / "repro_torch")]) == []


def test_port_lint_reports_the_jax_lint_findings():
    """Over the seeded-violation fixtures both lints report the same
    findings, messages included."""
    fixtures = [str(ROOT / "tests" / "lint_fixtures")]
    got = [dataclasses.astuple(v) for v in lint_paths(fixtures)]
    assert got == [dataclasses.astuple(v) for v in jax_lint_paths(fixtures)] and len(got) >= 6


# ------------------------------ chip_smoke.py's blob phase ------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("smoke", [True, False])
def test_second_burst_shares_the_system_prompt_with_new_tails(smoke):
    cfg = SimpleNamespace(vocab_size=128256)
    one, two = cell_requests(cfg, smoke=smoke), cell_requests(cfg, smoke=smoke, bursts=2)
    n, system = len(one), (16 if smoke else 128)
    assert [(r.request_id, r.prompt, r.max_new_tokens) for r in two[:n]] == \
        [(r.request_id, r.prompt, r.max_new_tokens) for r in one]
    assert [r.request_id for r in two[n:]] == list(range(n, 2 * n))
    assert all(r.prompt[:system] == one[0].prompt[:system] for r in two)
    tails = {tuple(r.prompt[system:]) for r in two}
    assert len(tails) == 2 * n


def test_chip_smoke_reports_the_first_diverging_token(capsys):
    cs = _chip_smoke()
    done = {0: SimpleNamespace(tokens=[1, 2, 3]), 1: SimpleNamespace(tokens=[4, 5, 6])}
    cs.check_same_tokens("blob engine B", done, dict(done), {}, {}, [0, 1])
    other = {0: done[0], 1: SimpleNamespace(tokens=[4, 7, 6])}
    la, lb = torch.zeros(10), torch.zeros(10)
    la[5], la[7], lb[5], lb[7] = 2.0, 1.5, 0.5, 1.0
    with pytest.raises(SystemExit):
        cs.check_same_tokens("blob engine B", done, other, {(1, 1): la}, {(1, 1): lb}, [0, 1])
    err = capsys.readouterr().err
    assert "blob engine B: request 1 diverges at token 1" in err
    assert "max |logits difference| 1.5000e+00" in err and "margin 5.0000e-01 in blob engine B" in err


def test_chip_smoke_wrappers_record_logits_and_client_calls(setup):
    """The blob phase's instruments on a blob engine: the recorded logits of
    each decode step pick the token the engine chose, and the client's
    calls are timed with the versions they wrote."""
    cs = _chip_smoke()
    _, _, tcfg, tparams = setup
    cluster, store = make_store(PORT, tcfg, 32)
    try:
        eng = make_engine(PORT, setup, tblob.BlobKVClient(store), 2)
        rec, calls = cs.record_logits(eng), cs.timed_calls(eng.kv, cs.BLOB_CALLS)
        tokens = serve(PORT, eng, [(0, PAGE, 12)])[0].tokens
        assert sorted(rec) == [(0, k) for k in range(1, 12)]
        assert [int(rec[(0, k)][: tcfg.vocab_size].argmax()) for k in range(1, 12)] == tokens[1:]
        assert [len(calls[c]) for c in cs.BLOB_CALLS] == [1, 0, 1, 1]
        (_, versions), = calls["publish_prompt"]
        assert len(versions) == 1 and versions[0] > 0
    finally:
        cluster.close()
