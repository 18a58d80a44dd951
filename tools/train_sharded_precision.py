#!/usr/bin/env python
"""How far rounding alone moves ``chip_smoke.py`` step 16's sharded training
from its oracles, in bf16 and in f32 compute, on the card.

For each compute dtype: the oracles of step 16 (a) (llama3_2-1b at all 16
layers, unsharded) and (b) (mixtral-8x7b at 1 layer, each data shard's
rows alone on one device), then the same four-rank cells of step 16 in the
JAX package's layout, each leaf's error against its oracle (max |d| over
max |oracle|). In bf16 also the oracle against itself run in 4
microbatches of one row in place of 2 of two: the spread of bf16 rounding
with no sharding at all. Prints the six worst leaves of each. Needs one
card; about 6 minutes::

    python3 tools/train_sharded_precision.py
"""

from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DTYPES = ("bfloat16", "float32")


def configs(dtype: str) -> tuple:
    return tuple(dataclasses.replace(c, compute_dtype=dtype) for c in cs._train_shard_configs())


def rank(ai, chosen, dtype, batches, paths):
    """Step 16's (a) and (b) cells on one rank, in ``dtype`` compute."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    llama, mixtral = configs(dtype)
    out = {"llama": cs._sharded_train_cell(llama, ai, chosen.device, batches["llama"], paths["llama"], in_turn=False)}
    gc.collect()
    torch.cuda.empty_cache()
    out["mixtral"] = cs._sharded_train_cell(mixtral, ai, chosen.device, batches["mixtral"], paths["mixtral"],
                                            in_turn=True)
    return {name: {k: cell[k] for k in ("losses", "leaf_errs")} for name, cell in out.items()}


def worst(leaf_errs: dict, n: int = 6) -> dict:
    return {part: sorted(((round(e, 6), leaf) for leaf, e in errs.items()), reverse=True)[:n]
            for part, errs in leaf_errs.items()}


def main() -> None:
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    work = ROOT / "build" / "train_sharded_precision"
    work.mkdir(parents=True, exist_ok=True)
    llama, mixtral = cs._train_shard_configs()
    batches = {"llama": cs._pipeline_batches(llama.vocab_size, cs.TRAIN_SHARD_ROWS, cs.TRAIN_SHARD_STEPS),
               "mixtral": cs._pipeline_batches(mixtral.vocab_size, cs.MOE_TRAIN_ROWS, 1)}
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        for dtype in DTYPES:
            llama, mixtral = configs(dtype)
            paths = {"llama": str(work / "llama.pt"), "mixtral": str(work / "mixtral.pt")}
            t0 = time.perf_counter()
            oracle = cs.llama_train_oracle(llama, dev, batches["llama"], paths["llama"])
            gc.collect()
            torch.cuda.empty_cache()
            moe_oracle = cs.moe_train_oracle(mixtral, dev, batches["mixtral"][0], paths["mixtral"])
            gc.collect()
            torch.cuda.empty_cache()
            print(f"{dtype}: oracles in {time.perf_counter() - t0:.1f} s, llama {oracle}, mixtral {moe_oracle}",
                  flush=True)
            if dtype == "bfloat16":
                inner = trainer.n_microbatches
                trainer.n_microbatches = lambda rows, grad_accum, n=1: 4
                try:
                    again = cs.llama_train_oracle(llama, dev, batches["llama"], str(work / "llama_a4.pt"))
                finally:
                    trainer.n_microbatches = inner
                gc.collect()
                torch.cuda.empty_cache()
                a, b = torch.load(work / "llama_a4.pt", mmap=True), torch.load(paths["llama"], mmap=True)
                spread = {part: {k: cs._leaf_err(a[part][k], b[part][k], dev) for k in a[part]} for part in a}
                print(f"  bf16 oracle in 4 microbatches against 2: losses {again} against {oracle}; worst leaves "
                      f"{worst(spread)}", flush=True)
            res = launch_mesh.spawn(rank, cs.RANKS, (dtype, batches, paths), model_parallel=cs.RANKS_MODEL,
                                    device="cuda", timeout_s=cs.TRAIN_SHARD_DEADLINE_S)
            for name, want in (("llama", oracle), ("mixtral", [moe_oracle])):
                for r, out in enumerate(res):
                    print(f"  {dtype} {name} rank {r}: losses {out[name]['losses']} against {want}; worst leaves "
                          f"{worst(out[name]['leaf_errs'])} ({card})", flush=True)
    finally:
        for p in work.glob("*.pt"):
            p.unlink()


if __name__ == "__main__":
    main()
