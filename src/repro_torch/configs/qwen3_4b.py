"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_head=128, d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1000000.0,
    remat=True,
)
SMOKE = TransformerConfig(
    name="qwen3-4b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=128, qk_norm=True, chunk_q=8, chunk_k=8,
)
