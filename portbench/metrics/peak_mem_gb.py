"""The device's peak of allocated memory over set-up and window, GB."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
