"""frame_step_ms: the program's STOPWATCH span `preprocess` (the frame
step: preprocess_bundle on a session's first frame, the captured
frame_step_tracked2 on every other, up to its dispatch) per frame, over
the window."""

UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    n = run.stopwatch_counts.get("preprocess", 0)
    return run.stopwatch_totals["preprocess"] / n * 1e3 if n else None
