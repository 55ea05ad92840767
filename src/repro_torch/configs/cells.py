"""The LM architectures the serving and training CLIs run
(``repro.configs.cells``): ``LM_ARCHS`` maps each name to its config module
and its optimizer's name. The reference's shape tables and cell builders
(abstract cells for its 512-device dry run) are still to port, with
``train/sharding.py`` (ROADMAP A.16 (ii))."""
LM_ARCHS = {
    "smollm-135m": ("repro_torch.configs.smollm_135m", "adamw"),
    "qwen3-4b": ("repro_torch.configs.qwen3_4b", "adamw"),
    "qwen2-1.5b": ("repro_torch.configs.qwen2_1_5b", "adamw"),
    "kimi-k2-1t-a32b": ("repro_torch.configs.kimi_k2_1t_a32b", "adafactor"),
    "granite-moe-1b-a400m": ("repro_torch.configs.granite_moe_1b_a400m", "adamw"),
}
