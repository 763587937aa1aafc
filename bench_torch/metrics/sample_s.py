"""``sample_s``: seconds a clip spends in the program's ``blade.sample`` span
(``T2VPipeline.sample_latents``), from its start to the later of its end
and the device's completion of the work launched inside it, read from the
program's counter ``sample.seconds`` (``blade_torch.utils.tracing.timed``)
and divided by the window's clips.

Counters total every count made in the process while a profiler recorded, so
the reading is the window's only in a process that profiles exactly one
window, as ``run.py`` does; the drivers do not reset them yet.
"""

from bench_torch.harness.program_trace import counters


def read(records):
    seconds, clips = counters().get("sample.seconds"), records.get("units")
    if not seconds or not clips:
        return None
    return seconds / clips
