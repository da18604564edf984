"""frames_per_s: all frames of all sessions over the sum of the
sessions' wall times, each from the pipeline's construction to the
synchronize after finish() (the benchmark's own clock)."""

UNIT = "frames/s"


def read(run):
    seconds = sum(s.timing.seconds for s in run.sessions)
    frames = sum(len(s.timing.frame_s) for s in run.sessions)
    return frames / seconds if seconds > 0 and frames else None
