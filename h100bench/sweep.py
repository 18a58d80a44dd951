"""The sweep that fixes an open-loop cell's rate (not run by a benchmark run).

    python3 h100bench/sweep.py --workload <name> --rates 3,4,5 --seconds 30 --seed 1

One process: the weights once, then for each rate a fresh engine (a new
pool, so no rate inherits another's cached pages), the cell's warm-up and
a window of ``--seconds``, exactly as ``run.py`` runs them but at that rate.
A rate is sustained when every request due in the window had its first
token by the window's end and the time to first token does not grow over
the window (the 95th percentile of the last third of the due requests
within twice that of the first third). One JSON line a rate, also appended
to ``chiprun_out/sweep-<workload>.jsonl``.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from h100bench import run, spec, weights

    run._caches()
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    run.prepare(device)
    params = weights.draw(cell.config["model"], args.seed, device)
    out = ROOT / "chiprun_out" / f"sweep-{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate"] = rate
        obs, peak = run.serve_window(cell, params, args.seed, args.seconds, False, device, 0.0)
        _, end = obs.window_span()
        due = sorted((r for r in obs.reqs.values() if obs.open_t <= r.due < obs.close_t), key=lambda r: r.due)
        ttft = [(min(r.first, end) if r.first is not None else end) - r.due for r in due]
        third = max(len(ttft) // 3, 1)
        attempted, failed = run.attempted_failed(obs)
        line = {"workload": args.workload, "rate": rate, "seed": args.seed, "attempted": attempted,
                "failed": failed, "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
                "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
                "ttft_p95_first_third_ms": float(np.percentile(ttft[:third], 95)) * 1e3,
                "ttft_p95_last_third_ms": float(np.percentile(ttft[-third:], 95)) * 1e3,
                "output_tok_s": spec.reader("e2e", "output_tok_s")(obs),
                "requests_before_window_end": sum(r.submit <= end for r in obs.reqs.values()),
                "memory_peak_bytes": peak}
        line["sustained"] = failed == 0 and line["ttft_p95_last_third_ms"] <= 2 * line["ttft_p95_first_third_ms"]
        print(json.dumps(line), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
