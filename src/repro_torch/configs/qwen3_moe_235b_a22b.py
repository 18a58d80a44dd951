"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,  # per-expert ffn
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    rope_theta=1000000.0,
    param_dtype="bfloat16",  # 235B total params
    grad_accum=8,
    remat_group=2,
    supports_500k=False,
)
