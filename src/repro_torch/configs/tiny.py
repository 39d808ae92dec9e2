"""Tiny same-tokenizer model pairs for CPU tests, examples and benchmarks.
The draft/target pair shares vocab (a speculative-decoding requirement)."""
from ..models.config import ModelConfig

tiny_target = ModelConfig(
    name="tiny-target", arch_type="dense", num_layers=4, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
    tie_embeddings=True, max_seq_len=1024, source="test")

tiny_draft = ModelConfig(
    name="tiny-draft", arch_type="dense", num_layers=2, d_model=64,
    n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=512, head_dim=32,
    tie_embeddings=True, max_seq_len=1024, source="test")

tiny_mid = ModelConfig(
    name="tiny-mid", arch_type="dense", num_layers=3, d_model=96,
    n_heads=2, n_kv_heads=2, d_ff=192, vocab_size=512, head_dim=48,
    tie_embeddings=True, max_seq_len=1024, source="test")

tiny_ssm = ModelConfig(
    name="tiny-ssm", arch_type="ssm", num_layers=2, d_model=64,
    n_heads=2, n_kv_heads=2, d_ff=0, vocab_size=512, ssm_state=16,
    ssm_headdim=32, ssm_expand=2, ssm_chunk=8, tie_embeddings=True,
    max_seq_len=1024, source="test")

CONFIGS = {c.name: c for c in [tiny_target, tiny_draft, tiny_mid, tiny_ssm]}

# benchmark-scale family: big enough that decode compute dominates the
# per-call dispatch overhead on CPU, so speculative speedups are measurable
# (the tiny-* family above is for fast unit tests only)
bench_target = ModelConfig(
    name="bench-target", arch_type="dense", num_layers=6, d_model=256,
    n_heads=8, n_kv_heads=4, d_ff=768, vocab_size=512, head_dim=32,
    tie_embeddings=True, max_seq_len=2048, source="bench")

bench_mid = ModelConfig(
    name="bench-mid", arch_type="dense", num_layers=4, d_model=192,
    n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=512, head_dim=48,
    tie_embeddings=True, max_seq_len=2048, source="bench")

bench_draft = ModelConfig(
    name="bench-draft", arch_type="dense", num_layers=2, d_model=96,
    n_heads=2, n_kv_heads=2, d_ff=192, vocab_size=512, head_dim=48,
    tie_embeddings=True, max_seq_len=2048, source="bench")

for _c in (bench_target, bench_mid, bench_draft):
    CONFIGS[_c.name] = _c
