"""stale_refine_ms: the program's STOPWATCH span `stale_refine` (the
re-registration of one frame finalized against a superseded keyframe,
GCSLAM._dispatch_refine on the tracking thread: its draws, the
registration and the dispatch of its stats' fetch) per stale frame, host
ms, over the window less the traced stretch. A program without the span
reads None."""

UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    n = run.stopwatch_counts.get("stale_refine", 0)
    return run.stopwatch_totals["stale_refine"] / n * 1e3 if n else None
