"""Training launcher, the counterpart of :mod:`repro.launch.train`: a
learnable bigram corpus stored as one blob and read through
:class:`TokenPipeline`, versioned incremental checkpoints on the same store
(:class:`BlobCheckpointer`, resumed at the optimizer's step with
``restore``), AdamW with gradient accumulation; on one device, or across
the ranks of an initialised process group on the elastic ``(data, model)``
mesh (``model_parallel`` its model axis).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2-1b --smoke --device cpu --steps 30

Across ranks (one process per rank; :func:`main` joins the group from
``RANK``/``WORLD_SIZE`` with ``MASTER_ADDR``/``MASTER_PORT``, or from the
JAX package's ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``):

    RANK=0 WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=29500 \
        PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2-1b --smoke --model-parallel 2

and the same with ``RANK`` 1-3. The params and both AdamW moments are
held in the JAX launcher's layout, ``param_shardings`` (heads, ffn, vocab
and the experts over ``model``, ``embed`` over ``data``: FSDP). Every rank
reads its ``batch_shardings`` block of each global batch, its rows alone,
from a pipeline over its own copy of the corpus (the blob store lives in
one process): ``TokenPipeline`` with the batch shards as its ranks reads
exactly the global reader's rows of that block (the global batch whole
where its rows do not divide over the batch shards), and rank 0 holds the
checkpoints of the logical state: every leaf is regathered before each
save, and a restore broadcasts each leaf and keeps this rank's block on
any mesh (:func:`repro_torch.storage.checkpoint.restore_onto_mesh`). Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.cluster import Cluster, Session
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline, write_token_corpus
from repro_torch.launch.mesh import init_distributed, make_axis_info, make_mesh_for_devices
from repro_torch.models.lm import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.storage.checkpoint import BlobCheckpointer, restore_onto_mesh
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step


def maybe_init_distributed(device="cuda"):
    """Join the process group the environment describes: ``RANK`` and
    ``WORLD_SIZE`` (``env://``, with ``MASTER_ADDR``/``MASTER_PORT``), or
    the JAX package's ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
    ``PROCESS_ID``. Returns what :func:`init_distributed` chose, or None
    (one process) when neither is set."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return init_distributed(int(env["RANK"]), int(env["WORLD_SIZE"]), "env://", device=device)
    if env.get("COORDINATOR_ADDRESS"):
        return init_distributed(int(env["PROCESS_ID"]), int(env["NUM_PROCESSES"]),
                                f"tcp://{env['COORDINATOR_ADDRESS']}", device=device)
    return None


def state_specs(cfg, axis_info):
    """The spec tree of the training state ``{"params", "opt"}`` as a rank
    holds it (the ``"jax"`` layout, :func:`shd.jax_specs`; the step
    replicated)."""
    specs = shd.jax_specs(cfg, axis_info)
    return {"params": specs, "opt": {"m": specs, "v": specs, "step": shd.P()}}


def _logical_meta(params, cfg):
    """The full shapes with the dtypes of ``params`` (a rank's blocks): the
    checkpointer's template of the logical params."""
    from repro_torch.convert import param_shapes

    return shd._map(lambda _, shape, leaf: torch.empty(shape, dtype=leaf.dtype, device="meta"),
                    param_shapes(cfg), params)



def pipeline_config(batch: int, seq: int, seed: int, axis_info) -> PipelineConfig:
    """The reader of this rank's rows of each global batch of ``batch``
    rows: its block over the batch axes, the batch shards as the reader's
    ranks (row ``k`` of rank ``i``'s step ``s`` is the global reader's row
    ``s*batch + i*batch/n + k``), or the whole batch on one device or where
    the rows do not divide over the shards."""
    rows = shd.row_block(batch, axis_info)
    b = rows.stop - rows.start
    return PipelineConfig(batch_per_rank=b, seq_len=seq, n_ranks=batch // b, rank=rows.start // b, seed=seed)


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
    tokens; returns the losses, the final state (this rank's), the
    checkpointer (None but on rank 0 across ranks), session, pipeline and
    ``axis_info`` (None on one device). Without ``session`` it makes a
    cluster of its own and closes it before returning. With ``restore``,
    resumes from the checkpointer's latest checkpoint, if it has one, at
    its step. Across ranks every rank of the process group calls it; the
    mesh is ``(world // model_parallel, model_parallel)``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, grad_accum=min(cfg.grad_accum, max(batch // 2, 1)))

    mesh = make_mesh_for_devices(model_parallel=model_parallel)
    axis_info = make_axis_info(mesh) if mesh.size > 1 else None
    rank = mesh.rank

    model = build_model(cfg)
    params = model.init(seed=seed, device=dev, axis_info=axis_info)  # this rank's blocks across ranks
    template = {"params": _logical_meta(params, cfg), "opt": adamw_init(_logical_meta(params, cfg))}
    opt_state = adamw_init(params)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(steps // 10, 1))
    step_fn = make_train_step(model, cfg, opt_cfg, axis_info)

    def full_state():
        """The logical state (every leaf regathered; every rank calls it)."""
        if axis_info is None:
            return {"params": params, "opt": opt_state}
        return {"params": shd.gather_params(params, cfg, axis_info),
                "opt": {"m": shd.gather_params(opt_state["m"], cfg, axis_info),
                        "v": shd.gather_params(opt_state["v"], cfg, axis_info), "step": opt_state["step"]}}

    own_cluster = session is None
    if own_cluster:
        session = Cluster(n_data_providers=4, n_metadata_providers=4).session()
    try:
        # ---- data: tokenized corpus in the blob store ----
        n_tokens = corpus_tokens(batch, seq)
        corpus = bigram_corpus(cfg.vocab_size, n_tokens, np.random.default_rng(seed))
        pipe = TokenPipeline(write_token_corpus(session, corpus), n_tokens,
                             pipeline_config(batch, seq, seed, axis_info))

        # ---- checkpointing: on rank 0, of the logical state ----
        ckpt = None
        if rank == 0:
            ckpt = BlobCheckpointer(session, template, page_size=1 << 16)
        start_step = 0
        if restore:
            if axis_info is None:
                found = bool(ckpt.checkpoints)
            else:
                flag = [bool(ckpt is not None and ckpt.checkpoints)]
                dist.broadcast_object_list(flag, src=0)
                found = flag[0]
            if found:
                if axis_info is None:
                    state = ckpt.restore(device=dev)
                else:
                    state = restore_onto_mesh(ckpt, state_specs(cfg, axis_info), axis_info, device=dev)
                params, opt_state = state["params"], state["opt"]
                start_step = int(opt_state["step"])
                pipe.set_step(start_step)

        losses = []
        t0 = time.time()
        for step in range(start_step, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch_dev, batch)
            losses.append(float(metrics["loss"]))
            if (step + 1) % checkpoint_every == 0 or step + 1 == steps:
                state = full_state()
                if ckpt is not None:
                    ckpt.save(step + 1, state)
            if step % 10 == 0 and rank == 0:
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
        "axis_info": axis_info,
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
    joined = maybe_init_distributed(args.device)
    try:
        out = train(
            args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
            seq=args.seq, model_parallel=args.model_parallel,
            checkpoint_every=args.checkpoint_every, restore=args.restore, lr=args.lr,
            device=joined.device if joined is not None else args.device,
        )
    finally:
        if joined is not None:
            dist.destroy_process_group()
    print(f"final loss {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
