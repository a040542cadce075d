"""Seconds from the start of the process to the window's opening: start-up,
kernel loading (building on a checkout's first run), weights, engine and
warm-up."""


def read(run):
    return run.setup_s
