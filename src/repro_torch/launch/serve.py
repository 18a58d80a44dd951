"""Serving launcher: batched requests through the paged-KV engine, the
counterpart of ``repro.launch.serve`` with a ``--device`` flag.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2-1b --smoke \
      --requests 8 --max-new 16 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.lm import build_model
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    params = model.init(seed=0, device=args.device, dtype=cfg.cdtype())
    engine = ServingEngine(cfg, params, max_slots=args.slots, n_pages=512, device=args.device)

    rng = np.random.default_rng(0)
    shared_prefix = rng.integers(0, cfg.vocab_size, 16).tolist()
    t0 = time.time()
    for i in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size, 8).tolist()
        engine.submit(Request(i, shared_prefix + tail, max_new_tokens=args.max_new))
    done = engine.run_until_drained()
    dt = time.time() - t0
    total_tokens = sum(len(c.tokens) for c in done.values())
    shared = sum(c.prefill_skipped_tokens for c in done.values())
    print(f"{len(done)} completions, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s) on {engine.device}, "
          f"prefix-cache hits: {shared} tokens")
    print("pool stats:", engine.alloc.stats)
    return done


if __name__ == "__main__":
    main()
