"""Single-device training launcher, the counterpart of
:mod:`repro.launch.train`: a learnable bigram corpus stored as one blob and
read through :class:`TokenPipeline`, versioned incremental checkpoints on
the same store (:class:`BlobCheckpointer`, resumed at the optimizer's step
with ``restore``), AdamW with gradient accumulation.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2-1b --smoke --device cpu --steps 30

Runs on the card unless ``--device cpu``. No multi-process or mesh
training: ``--model-parallel`` other than 1 raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.cluster import Cluster, Session
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline, write_token_corpus
from repro_torch.models.lm import build_model
from repro_torch.storage.checkpoint import BlobCheckpointer
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step


def corpus_tokens(batch: int, seq: int) -> int:
    return max(batch * (seq + 1) * 64, 1 << 16)


def bigram_corpus(vocab_size: int, n_tokens: int, rng: np.random.Generator) -> np.ndarray:
    """The JAX launcher's learnable synthetic corpus, token for token: a
    noisy affine bigram process (a uniform random stream has irreducible
    CE = ln(vocab) and nothing to learn), drawn from ``rng`` in the same
    order. The loop runs over Python ints; the values are the same."""
    nxt = ((np.arange(vocab_size, dtype=np.int64) * 31 + 7) % vocab_size).tolist()
    noise = (rng.random(n_tokens) < 0.1).tolist()
    rand_toks = rng.integers(0, vocab_size, n_tokens).tolist()
    out = [1] * n_tokens
    for i in range(1, n_tokens):
        out[i] = rand_toks[i] if noise[i] else nxt[out[i - 1]]
    return np.asarray(out, dtype=np.int32)


def train(
    arch: str,
    *,
    smoke: bool = False,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    model_parallel: int = 1,
    checkpoint_every: int = 20,
    restore: bool = False,
    seed: int = 0,
    lr: float = 3e-4,
    session: Optional[Session] = None,
    fail_at_step: Optional[int] = None,  # fault-injection hook for tests
    device="cuda",
):
    """Train ``arch`` for ``steps`` steps of ``batch`` rows of ``seq``
    tokens; returns the losses, the final state, the checkpointer, session
    and pipeline. Without ``session`` it makes a cluster of its own and
    closes it before returning. With ``restore``, resumes from the
    checkpointer's latest checkpoint, if it has one, at its step."""
    if model_parallel != 1:
        raise NotImplementedError("model-parallel training is not ported yet (ROADMAP Queue 1, item 6)")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, grad_accum=min(cfg.grad_accum, max(batch // 2, 1)))

    model = build_model(cfg)
    params = model.init(seed=seed, device=dev)
    opt_state = adamw_init(params)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(steps // 10, 1))
    step_fn = make_train_step(model, cfg, opt_cfg)

    own_cluster = session is None
    if own_cluster:
        session = Cluster(n_data_providers=4, n_metadata_providers=4).session()
    try:
        # ---- data: tokenized corpus in the blob store ----
        n_tokens = corpus_tokens(batch, seq)
        corpus = bigram_corpus(cfg.vocab_size, n_tokens, np.random.default_rng(seed))
        pipe = TokenPipeline(
            write_token_corpus(session, corpus), n_tokens,
            PipelineConfig(batch_per_rank=batch, seq_len=seq, n_ranks=1, rank=0, seed=seed),
        )

        # ---- checkpointing ----
        ckpt = BlobCheckpointer(session, {"params": params, "opt": opt_state}, page_size=1 << 16)
        start_step = 0
        if restore and ckpt.checkpoints:
            state = ckpt.restore(device=dev)
            params, opt_state = state["params"], state["opt"]
            start_step = int(opt_state["step"])
            pipe.set_step(start_step)

        losses = []
        t0 = time.time()
        for step in range(start_step, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch_dev)
            losses.append(float(metrics["loss"]))
            if (step + 1) % checkpoint_every == 0 or step + 1 == steps:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
            if step % 10 == 0:
                print(f"step {step} loss {losses[-1]:.4f} "
                      f"({(time.time() - t0) / max(step - start_step + 1, 1):.2f}s/step)", flush=True)
    finally:
        if own_cluster:
            session.cluster.close()
    return {
        "losses": losses,
        "params": params,
        "opt_state": opt_state,
        "checkpointer": ckpt,
        "session": session,
        "pipeline": pipe,
        "final_step": steps,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(
        args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, model_parallel=args.model_parallel,
        checkpoint_every=args.checkpoint_every, restore=args.restore, lr=args.lr,
        device=args.device,
    )
    print(f"final loss {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
