"""The per-level lane's readers, ``asa_levels_s`` and ``asa_level_merge_s``:
nothing where the program kept no such counter (another lane, or a program
without the spans), the counter's seconds over the window's clips where it
did."""

import pytest

from bench_torch.harness.registry import Registry

READERS = {"asa_levels_s": "asa.levels.seconds", "asa_level_merge_s": "asa.level_merge.seconds"}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_is_none_without_its_counter(monkeypatch, name):
    mod = Registry().module("metrics", name)
    monkeypatch.setattr(mod, "counters", lambda: {"sample.seconds": 4.0, "asa.calls": 3})
    assert mod.read({"units": 2}) is None
    monkeypatch.setattr(mod, "counters", dict)
    assert mod.read({"units": 2}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_is_its_counter_over_the_clips(monkeypatch, name):
    mod = Registry().module("metrics", name)
    monkeypatch.setattr(mod, "counters", lambda: {READERS[name]: 7.5, "asa.calls": 3})
    assert mod.read({"units": 3}) == pytest.approx(2.5)
    assert mod.read({"units": 0}) is None
