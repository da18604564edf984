"""device_idle_share: 1 - the union of the device ops' intervals over the
traced stretch's window (torch.profiler; tfbench/trace.py)."""

UNIT = "fraction"
MOVES = "frames_per_s"


def read(run):
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
