"""Set-up: from the start of the run's process to its first timed step."""


def read(rec):
    return rec["setup_s"]
