"""late_frame_ms: the median, over the last quarter of each session's
frames, of the wall time of the process_frame call that took each (the
benchmark's own clock): the frames that meet the most keyframes, the
largest BA and the fullest keyframe stack of the session. Beside
frame_ms_p95 and the session's own median it says whether the host's
work a frame grows with the keyframes."""

import numpy as np

UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    times = [t for s in run.sessions for t in s.timing.frame_s[len(s.timing.frame_s) * 3 // 4:]]
    return float(np.median(times) * 1e3) if times else None
