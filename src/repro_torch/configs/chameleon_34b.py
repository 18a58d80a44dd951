"""chameleon-34b [vlm] — early-fusion backbone; VQ image tokenizer is a STUB
(input_specs provides precomputed patch/token embeddings).
[arXiv:2405.09818; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    input_kind="embeds",
    param_dtype="bfloat16",
    grad_accum=16,
    remat_group=2,
    supports_500k=False,
)
