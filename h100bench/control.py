"""Readings for the limits of ``correct`` (not run by a benchmark run).

    python3 h100bench/control.py --workload <name> --seeds 1,2,3 --seconds 20 [--unaligned]

For each seed, in one process: the cell's weights, engine, warm-up and a
window of ``--seconds`` at the cell's own load, exactly as ``run.py`` runs
them; then over the sample ``run.py`` would hold to the reference:

* ``gap_max``: the program's reading (the widest gap of a served token
  below the float32 reference's best), with the first and the later served
  tokens apart;
* ``control_gap_max``: the control's reading: the reference in fp8 in the
  program's place (:func:`h100bench.check.control_gaps`);
* ``bf16_witness``: the same with the reference in bf16, as the program
  computes: how far bf16 rounding alone moves the tokens;
* ``check`` / ``correct`` and ``control_check`` / ``control_correct``: the
  program's numbers and the control's, each put through the harness's own
  comparison (:func:`h100bench.check.numbers`, ``verdict`` and ``passed``)
  against ``limits/<workload>.json``, as ``run.py`` judges a run: the program
  should read ``correct`` true and the control false.

``--unaligned`` drops the traffic's ``multiple_of``, so that prompts end
inside a page (the engine then samples a request's first token at the
padded prompt's last position). One JSON line a seed, also appended to
``chiprun_out/control-<workload>.jsonl``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def stats(gaps) -> dict:
    """Spread of the gaps of one sample: max, 99th and 90th percentiles,
    mean, and the share of tokens not the float32 reference's first."""
    import numpy as np

    g = np.concatenate(gaps)
    return {"max": float(g.max()), "p99": float(np.percentile(g, 99)), "p90": float(np.percentile(g, 90)),
            "mean": float(g.mean()), "share_off": float((g > 0).mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--unaligned", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from h100bench import check, run, spec, weights

    run._caches()
    cell = spec.load_cell(args.workload)
    if args.unaligned:
        cell.traffic["prompt"].pop("multiple_of", None)
    device = torch.device("cuda", 0)
    run.prepare(device)
    ref = spec.reference_module(cell.config)
    out = ROOT / "chiprun_out" / f"control-{args.workload}{'-unaligned' if args.unaligned else ''}.jsonl"
    out.parent.mkdir(exist_ok=True)
    model = cell.config["model"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        params = weights.draw(model, seed, device)
        obs, peak = run.serve_window(cell, params, seed, args.seconds, False, device, t0)
        picked = check.sample(obs, cell.limits, seed)
        t1 = time.perf_counter()
        gaps = check.reference_gaps(ref, params, model, picked, device)
        t2 = time.perf_counter()
        low = check.control_gaps(ref, params, model, picked, device)
        t3 = time.perf_counter()
        witness = check.control_gaps(ref, params, model, picked, device, "bf16")
        nums = check.numbers(obs, gaps)
        checked = check.verdict(nums, cell.limits)
        control = check.verdict(check.numbers(obs, low), cell.limits)
        line = {"workload": args.workload, "seed": seed, "unaligned": args.unaligned,
                "gap_max": nums["gap_max"], "first_gap_max": max(float(g[0]) for g in gaps),
                "later_gap_max": max((float(g[1:].max()) for g in gaps if len(g) > 1), default=0.0),
                "control_gap_max": max(float(g.max()) for g in low),
                "control_first_gap_max": max(float(g[0]) for g in low),
                "wrong_lengths": nums["wrong_lengths"], "tokens": nums["tokens_compared"],
                "requests": len(picked), "unaligned_prompts": sum(len(r.item.prompt) % model["kv_page_tokens"] != 0 for r in picked),
                "program": stats(gaps), "bf16_witness": stats(witness), "fp8_control": stats(low),
                "served_s": t1 - t0, "reference_s": t2 - t1, "control_s": t3 - t2,
                "memory_peak_bytes": peak, "completed": sum(r.tokens is not None for r in obs.reqs.values()),
                "check": checked, "correct": check.passed(checked) and bool(picked),
                "control_check": control, "control_correct": check.passed(control) and bool(picked)}
        print(json.dumps(line), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
        del params, obs
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
