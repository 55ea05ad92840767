"""The architectures and input shapes of the reference's cell table
(``repro.configs.cells``): ``LM_ARCHS`` maps each LM name to its config
module and its optimizer's name (the serving and training CLIs read it),
``GNN_ARCHS`` and ``EQV_ARCHS`` each GNN name to its config module, and
the shape tables give each family's input shapes at full and smoke size.
40 assigned cells: 5 LM x 4, 4 GNN x 4, 1 recsys x 4. The reference's cell
builders (abstract cells with PartitionSpec trees for its 512-device dry
run) are still to port, with ``train/sharding.py`` (ROADMAP A.16 (ii))."""
LM_SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    # long-context decode: one token against a 512k KV cache
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}
GNN_SHAPES = {
    "full_graph_sm": {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
                      "n_classes": 7},
    "minibatch_lg": {"n_nodes": 169984, "n_edges": 168960, "d_feat": 602,
                     "n_classes": 41},
    "ogb_products": {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
                     "n_classes": 47},
    "molecule": {"n_nodes": 3840, "n_edges": 8192, "d_feat": 64,
                 "n_classes": 16},
}
GNN_SMOKE_SHAPES = {
    "full_graph_sm": {"n_nodes": 40, "n_edges": 120, "d_feat": 12,
                      "n_classes": 5},
    "minibatch_lg": {"n_nodes": 176, "n_edges": 160, "d_feat": 12,
                     "n_classes": 5},
    "ogb_products": {"n_nodes": 64, "n_edges": 200, "d_feat": 12,
                     "n_classes": 5},
    "molecule": {"n_nodes": 20, "n_edges": 48, "d_feat": 8, "n_classes": 4},
}
RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "score", "batch": 512, "cands": 1024,
                  "per_user": True},
    "serve_bulk": {"kind": "score", "batch": 262144, "cands": 1024,
                   "per_user": False},
    "retrieval_cand": {"kind": "score", "batch": 1, "cands": 1_000_000,
                       "per_user": False},
}

LM_ARCHS = {
    "smollm-135m": ("repro_torch.configs.smollm_135m", "adamw"),
    "qwen3-4b": ("repro_torch.configs.qwen3_4b", "adamw"),
    "qwen2-1.5b": ("repro_torch.configs.qwen2_1_5b", "adamw"),
    "kimi-k2-1t-a32b": ("repro_torch.configs.kimi_k2_1t_a32b", "adafactor"),
    "granite-moe-1b-a400m": ("repro_torch.configs.granite_moe_1b_a400m", "adamw"),
}
GNN_ARCHS = {
    "graphcast": "repro_torch.configs.graphcast",
    "gat-cora": "repro_torch.configs.gat_cora",
}
EQV_ARCHS = {
    "egnn": "repro_torch.configs.egnn",
    "mace": "repro_torch.configs.mace",
}

ALL_ARCHS = (
    list(LM_ARCHS) + list(GNN_ARCHS) + list(EQV_ARCHS) + ["bert4rec"]
)


def arch_shapes(arch: str) -> list[str]:
    if arch in LM_ARCHS:
        return list(LM_SHAPES)
    if arch in GNN_ARCHS or arch in EQV_ARCHS:
        return list(GNN_SHAPES)
    if arch == "bert4rec":
        return list(RECSYS_SHAPES)
    raise ValueError(arch)


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ALL_ARCHS for s in arch_shapes(a)]
