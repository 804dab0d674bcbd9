"""Mean host seconds of a fresh aggregation step (the communication
round: both codecs, their draws, the mean, the new cached target) in the
traced window, a synchronize closing each step."""


def read(run):
    times = [s for branch, s in run.step_seconds if branch == 1]
    return sum(times) / len(times) if times else None
