"""seamless-m4t-medium [audio] — enc-dec transformer backbone; the speech
frontend is a STUB (input_specs provides precomputed frame embeddings).
[arXiv:2308.11596; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="audio",
    n_layers=24,  # 12 encoder + 12 decoder
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,  # MHA
    d_ff=4096,
    vocab_size=256206,
    input_kind="encdec",
    grad_accum=4,
    supports_500k=False,
)
