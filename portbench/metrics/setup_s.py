"""Seconds from the process's start to the window's: start-up, inputs,
warm-up, and in a first run the build of the cell's sources."""


def read(run):
    return run.setup_s
