"""fusion_cycle_ms: the program's STOPWATCH spans of one fusion cycle
(`reintegration`, `integration`, `meshing`, `gc`: the drift
reintegration, the keyframe's integration over its discovered chunks
through K2, the incremental marching cubes, GC and the keyframe budget),
per cycle (one `meshing` a cycle), over the window. The texture stage
between meshing and GC is texture_cycle_ms's."""

UNIT = "ms"
MOVES = "frames_per_s"
SPANS = ("reintegration", "integration", "meshing", "gc")


def read(run):
    n = run.stopwatch_counts.get("meshing", 0)
    if not n:
        return None
    return sum(run.stopwatch_totals.get(k, 0.0) for k in SPANS) / n * 1e3
