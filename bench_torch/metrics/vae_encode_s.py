"""``vae_encode_s``: seconds a clip spends in the program's ``blade.encode``
span (``T2VPipeline.encode_image``: an image-to-video clip's streaming VAE
encode of its first frame and the mask), from its start to the later of its
end and the device's completion of the work launched inside it, read from
the program's counter ``encode.seconds`` (``blade_torch.utils.tracing.timed``)
and divided by the window's clips.  A program without the span reads
nothing.

Counters total every count made in the process while a profiler recorded, so
the reading is the window's only in a process that profiles exactly one
window, as ``run.py`` does.
"""

from bench_torch.harness.program_trace import counters


def read(records):
    seconds, clips = counters().get("encode.seconds"), records.get("units")
    if not seconds or not clips:
        return None
    return seconds / clips
