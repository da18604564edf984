"""promotion_ms: the program's STOPWATCH spans of keyframe promotion,
per promotion, over the window. `promotion` is the update_frame call
that adopts a keyframe (it holds `pd_probe`, the loop-closure probe's
dispatch, and `pd_consume`); `t_u_pp` is the consume at the start of
every update_frame, which runs a deferred promotion's edges and BA
(`cpp_ba`) and the stale-frame refinements. pd_probe and cpp_ba lie
inside those two, so they are not added again."""

UNIT = "ms"
MOVES = "frame_ms_p95"


def read(run):
    n = run.stopwatch_counts.get("promotion", 0)
    if not n:
        return None
    t = run.stopwatch_totals
    return (t.get("promotion", 0.0) + t.get("t_u_pp", 0.0)) / n * 1e3
