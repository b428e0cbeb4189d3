"""A system module for the room test: the immutable store and ``GOpt``
that ``system.build`` gives, marked as built here."""
from perfbench import system


def build(config: dict, seed: int, device):
    sut = system.build(config, seed, device)
    sut.built_by = __name__
    return sut
