"""bert4rec [recsys]: embed_dim=64, 2 blocks, 2 heads, seq_len=200,
bidirectional sequence model [arXiv:1904.06690]. Item vocabulary sized for the
retrieval_cand shape (1M candidates)."""
from repro_torch.models.bert4rec import Bert4RecConfig

FULL = Bert4RecConfig(
    name="bert4rec", n_items=1_048_576, embed_dim=64, n_blocks=2, n_heads=2,
    seq_len=200,
)
SMOKE = Bert4RecConfig(
    name="bert4rec-smoke", n_items=500, embed_dim=16, n_blocks=2, n_heads=2,
    seq_len=12,
)
