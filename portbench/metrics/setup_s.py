"""Seconds from the process's start to the window's: imports, the
kernel build (cached after the first run), weights and tokens, and the
three warm-up steps."""


def read(run):
    return run.setup_s
