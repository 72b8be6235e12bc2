"""The benchmark's own roofline arithmetic: the card's peaks and the work
an operation needs, counted from its inputs, whatever kernel does it.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at
the full 700 W; each run records the card's power limit beside them.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 / fp16
PEAK_F32_FLOPS = 67e12       # CUDA cores, float32
HBM_BYTES_PER_S = 3.35e12


def hnsw_bound_s(rows: int, dists: int, dim: int, row_bytes: int) -> float:
    """The least time of an HNSW beam's work on the card: every row the
    plain beams need read once, and 3 int64 operations (a subtract, a
    multiply, an add) per element of each distance they need, at the
    float32 CUDA-core rate. The reverse prunes of an insert are left out,
    so this is a lower bound."""
    return max(rows * dim * row_bytes / HBM_BYTES_PER_S,
               3.0 * dim * dists / PEAK_F32_FLOPS)


def share(bound_s: float, busy_s) -> float | None:
    """Percent of the roofline reached: the bound over the device time;
    nothing where the trace saw no device time."""
    if not busy_s:
        return None
    return 100.0 * bound_s / busy_s


def lm_flops_per_doc(dims: dict, length: int) -> float:
    """Model FLOPs of one document's pooled forward (no head): 2 per
    weight a token uses (attention projections, the router, its k
    experts' three matrices) and the causal attention's QK^T and PV."""
    D, H, KV, Dh = (dims["d_model"], dims["num_heads"], dims["num_kv_heads"],
                    dims["head_dim"])
    per_token = (2 * D * H * Dh + 2 * D * KV * Dh) + D * dims["num_experts"] \
        + dims["top_k"] * 3 * D * dims["expert_d_ff"]
    attn = 2 * 2 * H * Dh * length * (length + 1) / 2
    return dims["num_layers"] * (2.0 * per_token * length + attn)
