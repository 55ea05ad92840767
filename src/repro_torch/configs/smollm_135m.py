"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, rope_theta=10000.0, remat=True,
)
SMOKE = TransformerConfig(
    name="smollm-135m-smoke", n_layers=2, d_model=48, n_heads=3, n_kv_heads=1,
    d_ff=96, vocab=128, chunk_q=8, chunk_k=8,
)
