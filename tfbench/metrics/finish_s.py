"""finish_s: the benchmark's clock around each session's finish() (the
final BA, the last reintegrations and remesh, the texture catch-up),
ending in a synchronize; the mean over the sessions."""

UNIT = "s"
MOVES = "frames_per_s"


def read(run):
    t = [s.timing.finish_s for s in run.sessions]
    return sum(t) / len(t) if t else None
