"""ba_round_ms: the program's STOPWATCH span `ba_gn_round` (one round of
slam.fastba.optimize: its Gauss-Newton iterations, the rollback test and
the outlier prune after every round but the last, dispatched op by op
with whatever they wait on) per round, host ms, over the window less the
traced stretch."""

UNIT = "ms"
MOVES = "frame_ms_p95"


def read(run):
    n = run.stopwatch_counts.get("ba_gn_round", 0)
    return run.stopwatch_totals["ba_gn_round"] / n * 1e3 if n else None
