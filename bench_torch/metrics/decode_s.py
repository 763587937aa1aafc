"""``decode_s``: host seconds a clip spends in ``decode_latents`` (from a
synchronize to a synchronize), the window's total over its clips."""


def read(records):
    return records.get("decode_s")
