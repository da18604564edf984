"""texture_cycle_ms: the program's STOPWATCH span `texture` (one texture
cycle's dispatch, and its consume where the cycle reads its own
results) per cycle, over the window."""

UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    n = run.stopwatch_counts.get("texture", 0)
    return run.stopwatch_totals["texture"] / n * 1e3 if n else None
