#!/usr/bin/env python
"""How far rounding alone moves ``chip_smoke.py``'s sharded cells from their
oracles, in bf16 and in f32 compute, on the card.

``serve``: step 15 (d)'s zamba2-2.7b. First the unsharded model alone: its
bf16 logits against the same model's f32 logits, and its bf16 logits for 4
rows against those rows of an 8-row run (a prefill of 2048 tokens a row,
then ``N_DECODE`` decode steps fed the bf16 model's greedy tokens): the
spread of bf16 rounding with no sharding at all. Then step 15 (d)'s four
ranks (the weights in the JAX layout, each rank its 4 rows' SSM states) in
each dtype against the unsharded oracle of that dtype: max |d| over max
|oracle| of the prefill and of the decode logits. All 54 layers unless
``--layers`` says fewer; about 7 minutes at 54 layers.

``train``: step 16's (a) (llama3_2-1b at ``TRAIN_SHARD_LAYERS``,
unsharded) and (b) (mixtral-8x7b at 1 layer, each data shard's rows alone
on one device) oracles in each dtype, then the same four-rank cells of
step 16 in the JAX package's layout, each leaf's error against its oracle
(max |d| over max |oracle|). In bf16 also the oracle against itself run in
4 microbatches of one row in place of 2 of two: the spread of bf16
rounding with no sharding at all. Prints the six worst leaves of each;
about 6 minutes.

Needs one card::

    python3 tools/sharded_precision.py serve [--layers 54]
    python3 tools/sharded_precision.py train
"""

from __future__ import annotations

import argparse
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


# ------------------------------ serve: step 15 (d) ------------------------------
def zamba2(dtype: str, layers: int):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("zamba2-2.7b"), n_layers=layers, compute_dtype=dtype,
                               kv_cache_dtype=dtype)


def serve_rank(ai, chosen, card, tokens, dtype, layers):
    """Step 15 (d) on one rank, in ``dtype``."""
    cs.shard_cells = lambda: (("zamba2", zamba2(dtype, layers), cs.PROMPT),)
    out = cs.sharded_rank(ai, chosen, card, {"zamba2": tokens})["zamba2"]
    return {k: out[k] for k in ("decode", "prefill") if k in out}


def teacher(cfg, prompt, tokens, dev) -> list:
    """The unsharded model's logits (prefill, then each decode step fed
    ``tokens``) for all of ``prompt``'s rows and for its first half."""
    from repro_torch.models.lm import build_model

    model = build_model(cfg)
    params = model.init(seed=0, device=dev, dtype=cfg.cdtype())
    runs = []
    for rows in (prompt.shape[0], prompt.shape[0] // 2):
        logits, cache = model.prefill(params, prompt[:rows])
        out = [logits]
        for t in tokens[:, :rows]:
            logits, cache = model.decode_step(params, cache, t)
            out.append(logits)
        runs.append(torch.stack(out).float().cpu())
        del cache
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def errs(got, want) -> tuple:
    """(prefill, decode) max |got - want| over max |want| (step 15's measure)."""
    e = cs._logit_errs(got, want)
    return float(e[0].max()), float(e[1:].max())


def serve(card: str, layers: int) -> None:
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as launch_mesh

    _build.build_all()
    dev = torch.device("cuda")
    bf16 = zamba2("bfloat16", layers)
    prompt = cs.prompt_tokens(bf16, 8, cs.PROMPT, dev)
    oracles = {dtype: cs.shard_oracle(zamba2(dtype, layers), "zamba2", cs.PROMPT, dev) for dtype in DTYPES}
    tokens = oracles["bfloat16"]["tokens"].to(dev)
    b8, b4 = teacher(bf16, prompt, tokens, dev)
    f8, _ = teacher(zamba2("float32", layers), prompt, tokens, dev)
    print(f"zamba2 at {layers} layers, unsharded, (prefill, decode) max |d| over max |want|: bf16 against f32 "
          f"{errs(b8, f8)}; bf16 4 rows against those of 8 {errs(b4, b8[:, :4])}; bf16 against f32 a decode "
          f"step {[round(float(x), 4) for x in cs._logit_errs(b8, f8)[1:].amax(-1)]} ({card})", flush=True)
    for dtype in DTYPES:
        t0 = time.perf_counter()
        res = launch_mesh.spawn(serve_rank, cs.RANKS, (card, oracles[dtype]["tokens"], dtype, layers),
                                model_parallel=cs.RANKS_MODEL, device="cuda", timeout_s=cs.SHARD_DEADLINE_S)
        prefill = torch.cat([res[d * cs.RANKS_MODEL]["prefill"] for d in range(cs.RANKS // cs.RANKS_MODEL)])
        p_err = float(cs._logit_errs(prefill[None], oracles[dtype]["prefill"][None]).max())
        d_err = float(cs._logit_errs(res[0]["decode"], oracles[dtype]["decode"]).max())
        print(f"step 15 (d) in {dtype} at {layers} layers against its unsharded oracle: prefill {p_err:.4e}, "
              f"decode {d_err:.4e} (SHARD_LOGITS_TOL {cs.SHARD_LOGITS_TOL}); ranks in "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)


# ------------------------------ train: step 16 (a), (b) ------------------------------
def train_configs(dtype: str) -> tuple:
    return tuple(dataclasses.replace(c, compute_dtype=dtype) for c in cs._train_shard_configs())


def train_rank(ai, chosen, dtype, batches, paths):
    """Step 16's (a) and (b) cells on one rank, in ``dtype`` compute."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    llama, mixtral = train_configs(dtype)
    out = {"llama": cs._sharded_train_cell(llama, ai, chosen.device, batches["llama"], paths["llama"], in_turn=False)}
    gc.collect()
    torch.cuda.empty_cache()
    out["mixtral"] = cs._sharded_train_cell(mixtral, ai, chosen.device, batches["mixtral"], paths["mixtral"],
                                            in_turn=True)
    return {name: {k: cell[k] for k in ("losses", "leaf_errs")} for name, cell in out.items()}


def worst(leaf_errs: dict, n: int = 6) -> dict:
    return {part: sorted(((round(e, 6), leaf) for leaf, e in errs.items()), reverse=True)[:n]
            for part, errs in leaf_errs.items()}


def train(card: str) -> None:
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.train import trainer

    dev = torch.device("cuda")
    work = ROOT / "build" / "train_sharded_precision"
    work.mkdir(parents=True, exist_ok=True)
    llama, mixtral = cs._train_shard_configs()
    batches = {"llama": cs._pipeline_batches(llama.vocab_size, cs.TRAIN_SHARD_ROWS, cs.TRAIN_SHARD_STEPS),
               "mixtral": cs._pipeline_batches(mixtral.vocab_size, cs.MOE_TRAIN_ROWS, 1)}
    try:
        for dtype in DTYPES:
            llama, mixtral = train_configs(dtype)
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
            res = launch_mesh.spawn(train_rank, cs.RANKS, (dtype, batches, paths), model_parallel=cs.RANKS_MODEL,
                                    device="cuda", timeout_s=cs.TRAIN_SHARD_DEADLINE_S)
            for name, want in (("llama", oracle), ("mixtral", [moe_oracle])):
                for r, out in enumerate(res):
                    print(f"  {dtype} {name} rank {r}: losses {out[name]['losses']} against {want}; worst leaves "
                          f"{worst(out[name]['leaf_errs'])} ({card})", flush=True)
    finally:
        for p in work.glob("*.pt"):
            p.unlink()


def main() -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cell", required=True)
    sub.add_parser("serve").add_argument("--layers", type=int, default=54)
    sub.add_parser("train")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if args.cell == "serve":
        serve(card, args.layers)
    else:
        train(card)


if __name__ == "__main__":
    main()
