"""Plain reference of the decoder that the serving cells run, in float32.

Token embedding, then per layer: RMSNorm, grouped-query attention (half-split
RoPE, causal, sliding window), residual, RMSNorm, and a gated SiLU MLP or a
top-k mixture of experts in which every token reaches its k experts (no
capacity, nothing dropped), residual; the final RMSNorm and the tied
unembedding. It reads the weight tree the benchmark drew and works out every
key and value again from the tokens: nothing the program made is read.

``precision="fp8"`` is the control: every projection and expert product
takes its operands rounded to float8 e4m3 (per-row scales for the
activations, per-output-column scales for the weights) and sums in float32,
as an fp8 serving path would; the router and the unembedding stay float32.
``precision="bf16"`` rounds those operands and the residual stream to
bfloat16 instead, as the program computes: a witness of how far bf16
rounding alone moves the served tokens.

Imports ``torch`` alone. Run it with TF32 off (``torch.backends.cuda.matmul.
allow_tf32 = False``): a float32 product may otherwise round to TF32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn
Q_CHUNK = 512  # query rows a score block holds


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``, back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """(N, a) x (a, b) in float32, or with fp8 operands for the control."""
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    if precision == "bf16":
        return (x.bfloat16() @ w.bfloat16()).float()
    return x @ w


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The residual stream as the precision holds it."""
    return x.bfloat16().float() if precision == "bf16" else x


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1; the two halves of hd are the rotated pair."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> torch.Tensor:
    """Causal attention of q (S, H, hd) over k, v (S, K, hd), query head h
    reading kv head h // (H / K); a key more than ``window - 1`` positions
    behind its query is masked. Scores in blocks of ``Q_CHUNK`` queries."""
    S, H, hd = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    for lo in range(0, S, Q_CHUNK):
        hi = min(lo + Q_CHUNK, S)
        first = 0 if window is None else max(0, lo - window + 1)
        s = torch.einsum("qhd,khd->hqk", q[lo:hi], k[first:hi]) / math.sqrt(hd)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(first, hi, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[first:hi])
    return out


def mlp(w: Dict[str, torch.Tensor], x: torch.Tensor, precision: str) -> torch.Tensor:
    h = linear(x, w["wi"], precision)
    g = linear(x, w["wg"], precision)
    return linear(torch.nn.functional.silu(g) * h, w["wo"], precision)


def moe(w: Dict[str, torch.Tensor], x: torch.Tensor, top_k: int, precision: str) -> torch.Tensor:
    """Each token's ``top_k`` experts by its float32 router logits, weighted
    by the softmax over those logits; every assignment is computed."""
    gates = x @ w["router"]
    top_w, top_e = torch.topk(gates, top_k, dim=-1)
    top_w = torch.softmax(top_w, dim=-1)
    out = torch.zeros_like(x)
    for e in range(w["router"].shape[1]):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = linear(xe, w["w1"][e], precision)
        g = linear(xe, w["wg"][e], precision)
        y = linear(torch.nn.functional.silu(g) * h, w["w2"][e], precision)
        out.index_add_(0, tok, y * top_w[tok, slot][:, None])
    return out


def _layer_f32(blocks, i: int):
    """Layer ``i`` of the stacked weight tree, every leaf a float32 copy."""
    if isinstance(blocks, dict):
        return {k: _layer_f32(v, i) for k, v in blocks.items()}
    return blocks[i].float()


def block(w, x: torch.Tensor, model: dict, precision: str) -> torch.Tensor:
    eps = model["norm_eps"]
    d, H, K, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], model["head_dim"]
    a = w["attn"]
    h = rmsnorm(x, w["ln1"], eps)
    q = rope(linear(h, a["wq"].reshape(d, H * hd), precision).reshape(-1, H, hd), model["rope_theta"])
    k = rope(linear(h, a["wk"].reshape(d, K * hd), precision).reshape(-1, K, hd), model["rope_theta"])
    v = linear(h, a["wv"].reshape(d, K * hd), precision).reshape(-1, K, hd)
    o = attention(q, k, v, model.get("sliding_window"))
    x = _round(x + linear(o.reshape(-1, H * hd), a["wo"].reshape(H * hd, d), precision), precision)
    h = rmsnorm(x, w["ln2"], eps)
    if model.get("n_experts", 0):
        return _round(x + moe(w["ffn"], h, model["top_k"], precision), precision)
    return _round(x + mlp(w["ffn"], h, precision), precision)


def logits(params, model: dict, seqs: Sequence[torch.Tensor], rows: Sequence[slice],
           precision: str = "f32") -> List[torch.Tensor]:
    """Float32 logits over the first ``vocab_size`` ids at ``rows[j]`` of each
    token sequence ``seqs[j]`` (1-D), all sequences layer by layer, so that
    one layer's weights are held in float32 at a time."""
    table = params["embed"]["table"]
    hs = [_round(table[s.long()].float(), precision) for s in seqs]
    for i in range(model["n_layers"]):
        w = _layer_f32(params["blocks"], i)
        hs = [block(w, h, model, precision) for h in hs]
        del w
    ln_f = params["ln_f"].float()
    emb = table.float()
    out = []
    for h, r in zip(hs, rows):
        hn = rmsnorm(h[r], ln_f, model["norm_eps"])
        out.append((hn @ emb.T)[:, : model["vocab_size"]])
    return out
