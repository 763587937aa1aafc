"""``attn_roofline.tdm``: the least time the H100 could take for the ASA
attention the window's training steps ran, forward and backward, over the
device time of that attention, in %.

The least time is the sum over the model forwards' ASA calls of max(
operations / 989 TFLOP/s, bytes / 3.35 TB/s)
(``harness.roofline.asa_energy_work``), and over those that took a
gradient the same of their backward
(``harness.roofline.asa_energy_backward_work``).  The device time is every
kernel launched inside the benchmark's ``bench.asa`` spans (a forward, or a
block recomputed in the backward) and every kernel launched by an autograd
node whose forward op ran inside one (``asa.backward``), whatever its name,
so a kernel that replaces another is held to the same work.  The recomputed
forward is in the time and not in the least time."""


def read(records):
    bound = records.get("asa_bound_s")
    spans = records.get("trace", {}).get("span_device_s", {})
    device = spans.get("asa", 0.0) + spans.get("asa.backward", 0.0)
    if not bound or not device:
        return None
    return 100.0 * bound / device
