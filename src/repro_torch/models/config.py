"""Model configuration: a jax-free copy of :class:`repro.models.config.ModelConfig`.

Same fields, derived properties and :meth:`ModelConfig.smoke`; the dtype
accessors return ``torch`` dtypes. Also the input-shape cells of the dry
run (:data:`SHAPES`), as in the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # tokens; None = full attention

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style): one shared attention block every `attn_every`
    attn_every: int = 0

    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # input modality: "tokens" (LM), "embeds" (vlm/audio backbone stubs),
    # "encdec" (frame embeddings into encoder + tokens into decoder)
    input_kind: str = "tokens"

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # KV cache paging (the paper's pages, in tokens)
    kv_page_tokens: int = 64
    kv_cache_dtype: str = "bfloat16"

    # execution
    attn_chunk: int = 1024  # q-chunk for flash-style chunked attention
    remat: str = "full"  # full | dots | none
    remat_group: int = 1  # checkpoint every g layers (carries shrink g×)
    use_pallas: bool = False
    grad_accum: int = 1

    # long-context applicability (sub-quadratic decode path exists)
    supports_500k: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # -- derived -------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def pdtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return _torch_dtype(self.compute_dtype)

    def kvdtype(self) -> torch.dtype:
        return _torch_dtype(self.kv_cache_dtype)

    # -- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; ``active_only`` counts top-k experts."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        dense_mlp = 3 * d * f  # gated SiLU MLP
        norms = 2 * d
        per_layer = attn + norms
        if self.is_moe:
            experts = self.top_k if active_only else self.n_experts
            per_layer += experts * 3 * d * f + d * self.n_experts  # experts + router
        elif self.family in ("ssm", "hybrid"):
            pass  # handled below
        else:
            per_layer += dense_mlp

        if self.family == "ssm" or self.family == "hybrid":
            di, n, g = self.d_inner, self.ssm_state, self.ssm_groups
            h = self.ssm_heads
            in_proj = d * (2 * di + 2 * g * n + h)
            conv = (di + 2 * g * n) * self.ssm_conv
            out_proj = di * d
            ssm_layer = in_proj + conv + out_proj + 2 * h + di + d
            if self.family == "ssm":
                total_layers = self.n_layers * ssm_layer
            else:
                shared_attn = attn + dense_mlp + 2 * d
                n_attn = self.n_layers // max(self.attn_every, 1)
                total_layers = self.n_layers * ssm_layer + shared_attn + 0 * n_attn
            embed = v * d + d
            return total_layers + 2 * embed if self.family == "ssm" else total_layers + 2 * v * d + d

        if self.family == "encdec":
            enc_layer = attn + dense_mlp + norms
            dec_layer = attn + attn + dense_mlp + 3 * d  # self + cross
            total = self.n_enc_layers * enc_layer + self.n_dec_layers * dec_layer
            return total + 2 * v * d + d

        return self.n_layers * per_layer + 2 * v * d + d

    # -- smoke reduction --------------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            capacity_factor=4.0,  # no capacity drops -> deterministic tests
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_dec_layers=2 if self.n_dec_layers else 0,
            sliding_window=32 if self.sliding_window else None,
            attn_chunk=32,
            kv_page_tokens=8,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
