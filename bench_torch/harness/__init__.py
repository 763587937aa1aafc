"""The harness core: registry, seeds, window, trace reduction, last line.

It knows no configuration, traffic mix or metric by name: each is found
through the names ``BENCHMARK.json`` gives it (``registry``).
"""
