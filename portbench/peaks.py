"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core
GPU data sheet, dense rates without sparsity, at the full 700 W power
limit), and the least time that a count of work can take."""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
# FP32 and FP64 outside the tensor cores: elementwise work, gathers and
# reductions
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def least_seconds(work):
    """Least seconds of one batched logp+grad from its count: the larger
    of its FLOPs over the peak named by ``work["peak"]`` and its bytes
    over the memory rate."""
    return max(work["flops"] / PEAK_FLOPS[work["peak"]],
               work["bytes"] / PEAK_BYTES_PER_S)
