"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,   # attention-free; placeholder
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    grad_accum=4,
    supports_500k=True,  # O(1) recurrent decode state
)
