"""mistral-large-123b [dense]. [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1000000.0,
    param_dtype="bfloat16",
    kv_cache_dtype="int8",  # per-token-scale quantized paged KV (§Perf hillclimb 3)  # 123B: fp32 params + fp32 adam would not fit one pod
    grad_accum=8,
    remat_group=2,
    supports_500k=False,
)
