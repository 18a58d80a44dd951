"""yi-9b [dense] — llama-arch GQA. [arXiv:2403.04652; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=10000.0,
    grad_accum=8,
    supports_500k=False,  # pure full attention -> long_500k skipped
)
