"""zamba2-2.7b [hybrid] — Mamba2 backbone + one shared attention block applied
every 6 layers. [arXiv:2411.15242; hf]

Simplification vs the HF checkpoint (noted in DESIGN.md): the shared block is
a plain pre-norm attn+MLP on the hidden stream (no concat-with-embedding input
and no per-application LoRA deltas).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2_7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,  # MHA shared block
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
    grad_accum=4,
    remat_group=2,
    supports_500k=True,  # hybrid: Mamba2 state + periodic attention
)
