"""Mean milliseconds of a cold ``GOpt.prepare`` (parse, type inference,
RBO, CBO, physical plan) over the suite's queries, in set-up."""
import statistics


def read(run):
    ms = run.get("prepare_ms")
    return statistics.fmean(ms) if ms else None
