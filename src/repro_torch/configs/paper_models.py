"""The paper's own draft/target families (Table 1/2): LLaMA3, Qwen2.5,
DeepSeek-R1-Distill-Qwen. These are the models PARD itself was evaluated on;
we carry them as first-class configs so the reproduction benchmarks and the
dry-run can exercise the paper's exact draft/target pairs."""
from ..models.config import ModelConfig

llama31_8b = ModelConfig(
    name="llama3.1-8b", arch_type="dense", num_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=500000.0, tie_embeddings=False, max_seq_len=131072,
    source="arXiv:2407.21783")

llama32_1b = ModelConfig(
    name="llama3.2-1b", arch_type="dense", num_layers=16, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab_size=128256, head_dim=64,
    rope_theta=500000.0, tie_embeddings=True, max_seq_len=131072,
    source="hf:meta-llama/Llama-3.2-1B")

qwen25_7b = ModelConfig(
    name="qwen2.5-7b", arch_type="dense", num_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064, head_dim=128,
    rope_theta=1000000.0, qkv_bias=True, tie_embeddings=False,
    max_seq_len=131072, source="arXiv:2412.15115")

qwen25_05b = ModelConfig(
    name="qwen2.5-0.5b", arch_type="dense", num_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151936, head_dim=64,
    rope_theta=1000000.0, qkv_bias=True, tie_embeddings=True,
    max_seq_len=32768, source="arXiv:2412.15115")

dsq_7b = ModelConfig(
    name="dsq-7b", arch_type="dense", num_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064, head_dim=128,
    rope_theta=1000000.0, qkv_bias=True, tie_embeddings=False,
    max_seq_len=131072, source="arXiv:2501.12948 (distill-qwen-7b)")

dsq_15b = ModelConfig(
    name="dsq-1.5b", arch_type="dense", num_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936, head_dim=128,
    rope_theta=1000000.0, qkv_bias=True, tie_embeddings=False,
    max_seq_len=131072, source="arXiv:2501.12948 (distill-qwen-1.5b)")

CONFIGS = {c.name: c for c in
           [llama31_8b, llama32_1b, qwen25_7b, qwen25_05b, dsq_7b, dsq_15b]}
