"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates): float32 outside the tensor cores, and HBM3
bandwidth. A roofline share or an mfu is stated against these, with the
card's power limit printed beside it."""

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def roofline_ms(n_ops, n_bytes):
    """The least time [ms] the card could take: the larger of the
    operations at the f32 peak and the bytes at the memory rate."""
    return 1e3 * max(n_ops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES)
