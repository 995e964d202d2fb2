"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W): the program's bench.py table of bf16
rates, frozen here, with the HBM bandwidth beside it. Shares of them are
stated with the card's power limit beside them."""

# (a part of torch.cuda.get_device_name(), dense bf16 TFLOP/s)
PEAK_BF16_TFLOPS = (("H100 80GB HBM3", 989.0), ("H100 SXM", 989.0))
PEAK_BF16_FLOPS = 989.0e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def peak_tflops(device_name: str):
    """The card's dense bf16 peak, or None for a card the table lacks."""
    for part, peak in PEAK_BF16_TFLOPS:
        if part in device_name:
            return peak
    return None
