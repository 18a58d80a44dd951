"""``chip_smoke.py``'s step 15 (serving across ranks, the weights in the
serving layout) end to end on 4 CPU ranks at smoke size: the card's calls
stubbed, the five cells cut to the smoke configs (zamba2's twice, (d') in
bf16 compute; 64-token prompts, 4
decode steps), the kernels' wrappers counting their calls as the card's
do. Every check of the step passes: the unsharded oracles run first in
this process, each rank's weights are the layout's bytes, both zamba2 cells'
SSM states its rows' (the layout's bytes, half the oracle's), its flash call on
its local heads and its paged call on its stripe agree with the plain
versions, the launches are the path's, the replicas' logits are bit-equal
and within ``SHARD_LOGITS_TOL`` of the oracles'."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 60.0
STUBBED = ("synchronize", "reset_peak_memory_stats", "empty_cache", "max_memory_allocated", "mem_get_info")


def _counting(fn):
    def run(*args, **kw):
        out = fn(*args, **kw)
        fn.launches += 1
        return out
    return run


def _chip_smoke_on_the_cpu():
    """``chip_smoke`` with the card's calls stubbed and step 15 cut to smoke size."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.mem_get_info = lambda *a, **k: (0, 0)
    cs.time_ms = lambda *a, **k: 1.0
    cs.PROMPT, cs.MIXTRAL_PROMPT, cs.N_DECODE, cs.SHARD_DEVICE = 64, 64, 4, "cpu"
    mixtral = dataclasses.replace(get_config("mixtral-8x7b").smoke(), n_layers=2)
    cs.SHARD_MIXTRAL_LAYERS = mixtral.n_layers
    cs.shard_cells = lambda: (("llama", get_config("llama3_2-1b").smoke(), 64), ("mixtral", mixtral, 64),
                              ("mistral", get_config("mistral-large-123b").smoke(), 64),
                              ("zamba2", get_config("zamba2-2.7b").smoke(), 64),
                              ("zamba2_bf16", dataclasses.replace(get_config("zamba2-2.7b").smoke(),
                                                                  compute_dtype="bfloat16"), 64))
    ops.flash_attention_cuda = _counting(fa.flash_attention_cuda)
    ops.paged_attention_cuda = _counting(pa.paged_attention_cuda)
    return cs


def _step15_rank(ai, chosen, *args):
    return _chip_smoke_on_the_cpu().sharded_rank(ai, chosen, *args)


def test_chip_smoke_step15_at_smoke_size(monkeypatch):
    from repro_torch.kernels import ops

    saved = {n: getattr(torch.cuda, n) for n in STUBBED}
    kernels = {n: getattr(ops, n) for n in ("flash_attention_cuda", "paged_attention_cuda")}
    try:
        cs = _chip_smoke_on_the_cpu()
        inner = launch_mesh.spawn
        monkeypatch.setattr(launch_mesh, "spawn", lambda fn, n, args, **kw: inner(
            _step15_rank, n, args, **{**kw, "device": "cpu", "timeout_s": DEADLINE_S}))
        out = cs.sharded_phase("cpu")
    finally:
        for n, f in saved.items():
            setattr(torch.cuda, n, f)
        for n, f in kernels.items():
            setattr(ops, n, f)
    json.dumps(out)  # the script prints it in its results line
    for name, cfg, _ in cs.shard_cells():
        row, layers = out[name], cs.attention_layers(cfg)
        assert row["max_err"] <= cs.SHARD_LOGITS_TOL and row["prefill_err"] <= cs.SHARD_LOGITS_TOL
        assert all(p == {"flash_attention": layers, "paged_attention": 0} for p in row["prefill_launches"])
        assert all(d == {"flash_attention": 0, "paged_attention": layers * 4} for d in row["launches"])
        assert len(set(row["weight_bytes"])) == 1 and 3 * row["weight_bytes"][0] < row["oracle_weight_bytes"]
        assert all(f["shape"]["H"] == cfg.n_heads // 2 for f in row["flash_check"])  # over 2 model ranks
    for i in (3, 4):
        name, cfg, _ = cs.shard_cells()[i]
        zamba2 = out[name]
        assert zamba2["layout_state_bytes"] == cs.layout_state_bytes(cfg, 4) > 0
        assert zamba2["state_bytes"] == zamba2["state_bytes_after_decode"] == [zamba2["layout_state_bytes"]] * 4
