"""``train_mfu``: the model operations of the window's training steps over
their host seconds at the H100's 989 TFLOP/s bf16 peak, in %.

The operations are what the steps need, counted from the configuration's
shapes and the masks the window's ASA calls selected, not from which kernel
ran them:

- each model forward (the rollout's, the distillation points', the
  teacher's and the fake score's, with or without gradient):
  ``reference/<family>.py::dense_flops`` (every projection, cross-attention,
  the embedders and the head) plus its ASA calls
  (``harness.roofline.asa_energy_work``: the selected pairs, the pooled
  keys, the predictor's scores);
- each backward (the fake score's and the generator's):
  ``reference/<family>.py::backward_flops`` (the input gradient of every
  block projection and of the head, cross-attention's at twice its forward,
  the LoRA factors' gradients; no weight gradient of the frozen base) plus
  twice each ASA call's attention operations
  (``harness.roofline.asa_energy_backward_work``).

A block recomputed in the backward (remat) is not counted: it is work the
program chose, not work the step needs."""

from bench_torch.harness.roofline import PEAK_BF16_FLOPS


def read(records):
    flops = records.get("model_flops", {}).get("train")
    seconds = records.get("step_total_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)
