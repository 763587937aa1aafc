"""``density.tdm``: mean, over every ASA mask the window's training steps'
model forwards built, of the share of full-resolution key blocks it
selects, in % (the energy lane's binary block mask, its forced last rows
and columns included; a block recomputed in the backward is not counted
again)."""


def read(records):
    d = records.get("density")
    return None if d is None else 100.0 * d
