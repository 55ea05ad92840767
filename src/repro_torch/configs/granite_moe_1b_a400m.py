"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) expert d_ff=512
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.transformer import MoESettings, TransformerConfig

FULL = TransformerConfig(
    name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=8, d_ff=512, vocab=49155, rope_theta=10000.0, remat=True,
    moe=MoESettings(n_experts=32, top_k=8, d_ff_expert=512, n_shared=0,
                    capacity_factor=1.25),
)
SMOKE = TransformerConfig(
    name="granite-moe-smoke", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=101, chunk_q=8, chunk_k=8,
    moe=MoESettings(n_experts=4, top_k=2, d_ff_expert=32, n_shared=0,
                    capacity_factor=2.0),
)
