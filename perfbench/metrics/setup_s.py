"""Seconds from the process's start to the first timed operation."""


def read(run):
    return run["setup_s"]
