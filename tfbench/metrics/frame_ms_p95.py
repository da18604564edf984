"""frame_ms_p95: the 95th percentile (linear between order statistics),
over every frame of every session, of the wall time of the
process_frame call that took it (the benchmark's own clock)."""

import numpy as np

UNIT = "ms"


def read(run):
    times = [t for s in run.sessions for t in s.timing.frame_s]
    return float(np.percentile(times, 95) * 1e3) if times else None
