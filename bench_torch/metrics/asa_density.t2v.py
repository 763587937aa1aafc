"""``asa_density.t2v``: the share of full-resolution key blocks the window's
ASA calls selected, in %, from the program's own counters
(``blade_torch.utils.tracing``): 100 x ``asa.blocks_selected`` /
``asa.blocks_total``, summed over every call of a model forward (energy
lane: the binary block mask, its forced last rows and columns included;
multilevel lane: the level-1 lists).  Every mask of a cell has one size, so
it reads as ``density.t2v``, the mean of the masks' shares.

Counters total every count made in the process while a profiler recorded, so
the reading is the window's only in a process that profiles exactly one
window, as ``run.py`` does; the drivers do not reset them yet.
"""

from bench_torch.harness.program_trace import counters


def read(records):
    c = counters()
    if not c.get("asa.blocks_total"):
        return None
    return 100.0 * c["asa.blocks_selected"] / c["asa.blocks_total"]
