"""ba_capture_ms: the program's STOPWATCH span `ba_capture` (a BA round
whose keyframe and edge buckets had no captured program yet: its eager
run and its capture, which stall the tracking thread) summed over the
window less the traced stretch, a session, host ms: the cost of the
buckets a session first reaches inside the window. The stalls fall on
about 18 frames of a long session, too few to move its 95th percentile,
so they show in frames_per_s. A program that counts its captures
without timing them reads None."""

UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    t = run.stopwatch_totals.get("ba_capture")
    if t is None or not run.sessions:
        return None
    return t / len(run.sessions) * 1e3
