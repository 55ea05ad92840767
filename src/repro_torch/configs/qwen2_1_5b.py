"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
— GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_head=128, d_ff=8960, vocab=151936, qkv_bias=True, rope_theta=1000000.0,
    remat=True,
)
SMOKE = TransformerConfig(
    name="qwen2-1.5b-smoke", n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
    d_ff=96, vocab=128, qkv_bias=True, chunk_q=8, chunk_k=8,
)
