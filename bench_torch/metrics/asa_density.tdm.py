"""``asa_density.tdm``: the share of full-resolution key blocks the ASA calls
of the window's training steps selected, in %, from the program's own
counters (``blade_torch.utils.tracing``): 100 x ``asa.blocks_selected`` /
``asa.blocks_total`` over the model forwards (the energy lane's binary
block mask, its forced last rows and columns included).  A block recomputed
in the backward counts under ``asa.recomputed_calls`` alone, so it reads as
``density.tdm``.

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
