"""Seconds from the process's start to the window's first timed call:
imports, inputs, the program's construction, build, warm-up, capture."""


def read(rec):
    return rec.setup_s
