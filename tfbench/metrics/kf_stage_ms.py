"""kf_stage_ms: the program's STOPWATCH spans `kf_stage_out` (an old
keyframe's local depths and quality moved to host memory once the
keyframe state passes tsdf.keyframe_device_budget_mb) and `kf_restage`
(a staged keyframe's state brought back to the card for one pass)
summed over the window less the traced stretch, a session, host ms: the
cost of holding more keyframes than the device budget. A program
without either span reads None."""

UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    spans = [run.stopwatch_totals[k] for k in ("kf_stage_out", "kf_restage")
             if k in run.stopwatch_totals]
    if not spans or not run.sessions:
        return None
    return sum(spans) / len(run.sessions) * 1e3
