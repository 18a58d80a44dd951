"""llama3.2-1b [dense] — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3_2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    rope_theta=500000.0,
    grad_accum=4,
    supports_500k=False,
)
