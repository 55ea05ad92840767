"""Three-term roofline from a step's record (``repro.roofline.report``),
with the constants of one NVIDIA H100 80GB HBM3 (SXM5, 700 W power limit)
in place of the reference's TPU v5e ones. Source of all three: NVIDIA's H100
Tensor Core GPU datasheet, SXM column, dense rates (no sparsity). A card
set below 700 W runs slower than these peaks under load, so a record's
roofline fraction is stated beside the card's power limit."""
from __future__ import annotations

# dense bfloat16 on the tensor cores, FLOP/s (datasheet: 989 TFLOPS, H100 SXM)
PEAK_FLOPS = 989e12
# HBM3 bandwidth, bytes/s (datasheet: 3.35 TB/s, H100 SXM)
HBM_BW = 3.35e12
# NVLink 4 per GPU, bytes/s in one direction (datasheet: 900 GB/s over its 18
# links, counting both directions). A ring collective sends and receives its
# wire bytes at once, so the time of a GPU's wire bytes (those it sends,
# ``roofline.hlo``'s ring volumes in the reference) is set by one direction:
# 450 GB/s.
NVLINK_BW = 450e9


def roofline_terms(record: dict) -> dict:
    """record: one step's json (per-device flops and bytes, wire bytes, chips)."""
    flops = record["cost"].get("flops", 0.0)
    mem_bytes = record["cost"].get("bytes_accessed", 0.0)
    wire = record["collectives"]["wire_bytes_total"]
    chips = record["chips"]
    compute_s = flops / PEAK_FLOPS
    memory_s = mem_bytes / HBM_BW
    collective_s = wire / NVLINK_BW
    bound = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    step_s = max(compute_s, memory_s, collective_s)
    model_flops = record.get("model_flops", 0.0)
    hlo_total = flops * chips
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bound": bound,
        "step_s_lower_bound": step_s,
        "model_flops": model_flops,
        "hlo_flops_total": hlo_total,
        "useful_flop_ratio": (model_flops / hlo_total) if hlo_total else 0.0,
        # fraction of roofline: useful work per second vs peak if compute-bound
        "roofline_fraction": (
            (model_flops / chips / PEAK_FLOPS) / step_s if step_s > 0 else 0.0
        ),
    }
