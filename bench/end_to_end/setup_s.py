"""Seconds from the process's start to the first timed request: loading,
the data and the inserts of set-up, the flush, the warm-up, and in a run
that compiles, compilation (the harness's host clock)."""


def read(rec: dict) -> float:
    return rec["setup_s"]
