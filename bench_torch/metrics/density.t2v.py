"""``density.t2v``: mean, over every ASA mask the window's clips built, of
the share of full-resolution key blocks it selects, in % (energy lane: the
binary block mask, its forced last rows and columns included)."""


def read(records):
    d = records.get("density")
    return None if d is None else 100.0 * d
