"""The table of peaks: published dense rates of the cards the benchmark
knows, by the name ``torch.cuda.get_device_name()`` gives.

NVIDIA's H100 data sheet (dense, no sparsity, at the 700 W limit of the
SXM part): 989 TFLOP/s bf16, 3.35 TB/s of HBM3. A card set below its
limit runs slower; the run prints the limit beside its numbers. A card
not in the table has no peak, and every share of a peak is left out of
its line."""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(card_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(card_name)
