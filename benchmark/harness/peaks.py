"""Published peaks of the cards the benchmark runs on, for roofline
shares: NVIDIA's H100 SXM data sheet (dense, no sparsity), at the full
700 W power limit; the run prints the card's own limit beside them."""

PEAKS = {
    "H100": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak_for(device_name: str):
    """The peaks of the card named ``device_name``, or None if unknown."""
    for key, peak in PEAKS.items():
        if key in device_name:
            return peak
    return None
