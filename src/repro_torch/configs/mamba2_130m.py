"""mamba2-130m — attention-free SSM (SSD, state-space duality).
[arXiv:2405.21060] 24L d_model=768 vocab=50280 ssm_state=128, expand=2,
headdim=64 (24 ssd heads), no MLP blocks. A copy of
``repro.configs.mamba2_130m``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    n_heads=12,          # unused (attention-free); kept for head_dim math
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    tie_embeddings=True,
    max_seq_len=1048576,
    source="arXiv:2405.21060",
)
