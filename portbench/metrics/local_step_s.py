"""Mean host seconds of a local-branch step in the traced window, a
synchronize closing each step."""


def read(run):
    times = [s for branch, s in run.step_seconds if branch == 0]
    return sum(times) / len(times) if times else None
