"""One run of one benchmark cell of the PyTorch/CUDA port (``repro_torch``)
on NVIDIA H100 cards.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names a model
configuration, a traffic mix and its metrics, each a file of its own under
``h100bench/`` (:mod:`h100bench.spec`). The run draws the weights on the card
from ``--seed``, builds ``repro_torch.serving.engine.ServingEngine`` with the
configuration's slots and pages, serves each prompt length the mix uses
once (set-up), ramps the traffic, and measures for ``--seconds``. Then it
reads the peak memory, frees the engine, holds a sample of the served
tokens to the plain float32 reference (:mod:`h100bench.check`) and prints
one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read
from a profiler trace of a short stretch), ``device`` and, last, ``check``:
each number compared with its limit, which also end standard error.

It exits non-zero and prints no result where there is no card, fewer cards
than the cell asks for, no ``src/repro_torch`` beside it, or where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once the window
has closed. Build and kernel caches live under ``build/`` in the checkout.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _caches() -> None:
    cache = ROOT / "build" / "h100bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")


def warm_shapes(engine, items) -> None:
    """Serve one request of each padded prompt length the mix uses (two
    tokens each): every prefill shape and the decode step run once before
    the window. The prompts repeat one token, so they share their pages and
    hold at most the longest one's in the prefix cache."""
    from repro_torch.serving.engine import Request

    T = engine.cfg.kv_page_tokens
    for i, n in enumerate(sorted({-(-len(it.prompt) // T) * T for it in items})):
        engine.submit(Request(-1 - i, [1] * n, max_new_tokens=2))
        engine.run_until_drained()


def attempted_failed(obs):
    """Open loop: the requests due in the window, and those of them without a
    first token by its end. Closed loop: the requests sent in the window; none fails."""
    _, end = obs.window_span()
    if obs.loop == "closed":
        return sum(obs.open_t <= r.submit < obs.close_t for r in obs.reqs.values()), 0
    due = [r for r in obs.reqs.values() if obs.open_t <= r.due < obs.close_t]
    return len(due), sum(r.first is None or r.first > end for r in due)


def model_config(cell):
    """The program's ``ModelConfig`` for the cell's configuration file."""
    from repro_torch.models.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cell.config["model"].items() if k in fields})


def build_engine(cell, params, device):
    from repro_torch.serving.engine import ServingEngine

    eng = cell.config["engine"]
    return ServingEngine(model_config(cell), params, max_slots=eng["max_slots"], n_pages=eng["n_pages"],
                         max_pages_per_seq=eng["max_pages_per_seq"], device=device)


def requests(cell, seed: int, seconds: float):
    from h100bench import traffic

    tr = cell.traffic
    n = tr["requests"] if tr["loop"] == "closed" else traffic.open_count(tr, tr["warmup_s"] + seconds)
    return traffic.generate(tr, cell.config["model"]["vocab_size"], seed, n)


def serve_window(cell, params, seed: int, seconds: float, trace: bool, device, t_process: float):
    """Engine, warm-up, window. Returns (observations, peak bytes); the
    engine is freed."""
    import torch

    from h100bench import serve

    engine = build_engine(cell, params, device)
    items = requests(cell, seed, seconds)
    warm_shapes(engine, items)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
    obs = serve.run(engine, items, cell.traffic, seconds, cell.config["model"], trace=trace, t_process=t_process)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del engine
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return obs, peak


def prepare(device) -> None:
    import torch

    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_process: float = T_PROCESS) -> dict:
    import torch

    from h100bench import check, spec, weights

    prepare(device)
    model = cell.config["model"]
    params = weights.draw(model, seed, device)
    obs, peak = serve_window(cell, params, seed, seconds, trace, device, t_process)
    picked = check.sample(obs, cell.limits, seed)
    gaps = check.reference_gaps(spec.reference_module(cell.config), params, model, picked, device)
    nums = check.numbers(obs, gaps)
    checked = check.verdict(nums, cell.limits)
    kind, metrics = ("metrics", cell.per_layer) if trace else ("e2e", cell.end_to_end)
    attempted, failed = attempted_failed(obs)
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": check.passed(checked) and bool(picked), "attempted": attempted, "failed": failed,
              "metrics": spec.read_all(kind, metrics, obs), "device": dev}
    if trace and obs.trace is not None:
        dev.update(busy_s=obs.trace["busy_s"], window_s=obs.trace["window_s"])
        result["breakdown"] = obs.trace["breakdown"]
    result["check"] = checked
    print(f"h100bench: {len(picked)} requests, {nums['tokens_compared']} served tokens held to the reference; "
          + ", ".join(f"{k} {v}" for k, v in nums.items() if k not in checked), file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"h100bench: no src/repro_torch under {ROOT}: nothing to measure", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    _caches()
    from h100bench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"h100bench: loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
