"""Random weights for a cell, drawn on the device from the run's seed.

One ``torch.Generator`` on the device draws every leaf in a fixed order,
one ``normal_`` call a stacked leaf, straight into the dtype it is served
in (the MoE router in float32). The tree is the one
``repro_torch.serving.engine.ServingEngine(cfg, params)`` takes, and the
benchmark hands the same tensors to the reference.
"""

from __future__ import annotations

import torch


def draw(model: dict, seed: int, device) -> dict:
    """Weights of the decoder ``model`` (a configuration's ``model`` dict):
    projections with std 1/sqrt(fan-in), norm scales about 1, the tied
    table with std 0.02 over the padded vocabulary."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = getattr(torch, model["compute_dtype"])
    L, d, H, K, hd, f = (model[k] for k in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    vocab = -(-model["vocab_size"] // 256) * 256

    def normal(shape, std, mean=0.0, dtype=dt):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(mean, std, generator=gen)

    table = normal((vocab, d), 0.02)
    attn = {"wq": normal((L, d, H, hd), d ** -0.5), "wk": normal((L, d, K, hd), d ** -0.5),
            "wv": normal((L, d, K, hd), d ** -0.5), "wo": normal((L, H, hd, d), (H * hd) ** -0.5)}
    E = model.get("n_experts", 0)
    if E:
        ffn = {"router": normal((L, d, E), d ** -0.5, dtype=torch.float32),
               "w1": normal((L, E, d, f), d ** -0.5), "wg": normal((L, E, d, f), d ** -0.5),
               "w2": normal((L, E, f, d), f ** -0.5)}
    else:
        ffn = {"wi": normal((L, d, f), d ** -0.5), "wg": normal((L, d, f), d ** -0.5),
               "wo": normal((L, f, d), f ** -0.5)}
    blocks = {"ln1": normal((L, d), 0.1, 1.0), "attn": attn, "ln2": normal((L, d), 0.1, 1.0), "ffn": ffn}
    return {"embed": {"table": table}, "blocks": blocks, "ln_f": normal((d,), 0.1, 1.0)}
