"""Seconds of ``GOpt(store)`` (statistics and GLogue's counts, which
probe through K1 on the card), host clock, synchronised."""


def read(run):
    return run["glogue_s"]
