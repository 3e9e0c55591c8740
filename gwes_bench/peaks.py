"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates without sparsity, at the full power limit of
700 W).  A roofline share is stated against these, with the card's power
limit beside it."""

from __future__ import annotations

PEAKS = {
    "H100": {
        "int8_ops_per_s": 1979e12,
        "bf16_flops_per_s": 989e12,
        "tf32_flops_per_s": 495e12,
        "fp64_tensor_flops_per_s": 67e12,
        "fp32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(device_name: str, key: str) -> float | None:
    """The peak ``key`` of the card named ``device_name`` (matched by the
    family's name in it), or None for a card not in the table."""
    for family, peaks in PEAKS.items():
        if family in device_name:
            return peaks.get(key)
    return None
