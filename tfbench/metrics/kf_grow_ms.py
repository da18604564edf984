"""kf_grow_ms: the program's STOPWATCH span `kf_grow` (a doubling of the
keyframe-indexed state: the pose array, the loop-closure and keypoint
DBs, the observation columns; or of the edge store) summed over the
window less the traced stretch, a session, host ms: what a session that
outgrows its initial capacities pays for growing them, on the tracking
or the fusion thread. A program without the span (fixed capacities)
reads None."""

UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    t = run.stopwatch_totals.get("kf_grow")
    if t is None or not run.sessions:
        return None
    return t / len(run.sessions) * 1e3
