"""Percent of the traced steps in which no device operation ran."""

from apspbench import trace


def read(rec):
    return None if rec["trace"] is None else trace.idle_share(rec["trace"])
