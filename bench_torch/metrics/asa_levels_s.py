"""``asa_levels_s``: seconds a clip spends in the program's ``blade.asa.levels``
spans (the per-level multilevel lane's pyramid pack and its three pooled
levels), each from its start to the later of its end and the device's
completion of the work launched inside it, read from the program's counter
``asa.levels.seconds`` (``blade_torch.utils.tracing.timed``) and divided by
the window's clips.  None where the program has no such counter: no call
took the per-level lane, or the program has not the span.

Counters total every count made in the process while a profiler recorded, so
the reading is the window's only in a process that profiles exactly one
window, as ``run.py`` does.
"""

from bench_torch.harness.program_trace import counters


def read(records):
    seconds, clips = counters().get("asa.levels.seconds"), records.get("units")
    if not seconds or not clips:
        return None
    return seconds / clips
