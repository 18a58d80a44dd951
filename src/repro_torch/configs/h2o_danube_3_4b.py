"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10000.0,
    grad_accum=4,
    supports_500k=True,  # SWA -> sub-quadratic long-context decode
)
