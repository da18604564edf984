"""ba_replay_share: the share of BA's Gauss-Newton rounds that replayed a
captured program, over the window less the traced stretch: the program's
STOPWATCH counts `ba_replay` (a round whose keyframe and edge buckets
had a program already) over `ba_replay` + `ba_capture` (a round with new
buckets: its eager run and its capture). A program that captures no BA
round counts neither, and the reader returns None."""

UNIT = "fraction"
MOVES = "frame_ms_p95"


def read(run):
    replay = run.stopwatch_counts.get("ba_replay", 0)
    n = replay + run.stopwatch_counts.get("ba_capture", 0)
    return replay / n if n else None
