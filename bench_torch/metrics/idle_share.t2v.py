"""``idle_share.t2v``: the share of the traced window in which the device
runs nothing, in %: window minus the union of its kernel, copy and set
intervals, over the window (``harness.trace.reduce_trace``)."""


def read(records):
    t = records.get("trace")
    if not t or not t["busy_s"]:  # no device activity traced: nothing to read
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
