"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 experts top-8 + 1 shared — trillion-param MoE
[arXiv:2501.kimi2; paper-table, unverified]. Adafactor (factored moments):
full Adam state for ~1.04T params does not fit 512 x 16GB (DESIGN.md §5).
"""
from repro_torch.models.transformer import MoESettings, TransformerConfig

FULL = TransformerConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, rope_theta=50000.0, remat=True,
    # production defaults = EXPERIMENTS.md §Perf-1 winners (fsdp + accum 8);
    # the paper-table baseline is reproduced with
    #   --set fsdp_params=false --set grad_accum=4
    grad_accum=8, fsdp_params=True,
    moe=MoESettings(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1,
                    capacity_factor=1.25),
)
OPTIMIZER = "adafactor"
SMOKE = TransformerConfig(
    name="kimi-k2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128, chunk_q=8, chunk_k=8,
    moe=MoESettings(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                    capacity_factor=2.0),
)
