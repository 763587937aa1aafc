"""``denoise_mfu``: the model operations of the window's denoising over its
host seconds at the H100's 989 TFLOP/s bf16 peak, in %.

The operations are what the DiT computes, counted from the
configuration's shapes (``reference/<family>.py::dense_flops``: every
projection, cross-attention, the embedders and the head) and, for
self-attention, from the masks the window's ASA calls selected
(``harness.roofline.asa_energy_work``), not from which kernel ran them."""

from bench_torch.harness.roofline import PEAK_BF16_FLOPS


def read(records):
    flops = records.get("model_flops", {}).get("denoise")
    seconds = records.get("denoise_total_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)
