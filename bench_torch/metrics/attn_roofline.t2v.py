"""``attn_roofline.t2v``: the least time the H100 could take for the ASA
attention the window's clips ran, over the device time of that attention,
in %.

The least time is the sum over ASA calls of max(operations / 989 TFLOP/s,
bytes / 3.35 TB/s) (``harness.roofline.asa_energy_work``: the selected
pairs, the pooled branch and the predictor's scores; Q, K, V in and the
output out).  The device time is every kernel launched inside the
benchmark's ``bench.asa`` spans, whatever its name, so a kernel that
replaces another is held to the same work."""


def read(records):
    bound = records.get("asa_bound_s")
    device = records.get("trace", {}).get("span_device_s", {}).get("asa")
    if not bound or not device:
        return None
    return 100.0 * bound / device
