"""tracking_offcpu_ms: the tracking thread's time off the CPU a frame:
the program's STOPWATCH aggregate `frame_offcpu` (each `frame` span, one
process_frame call, its wall time less its thread CPU time) per frame,
over the window less the traced stretch. Waits on the card spin on the
CPU under CUDA's default schedule (a 50 ms device sleep and its
synchronize read 50 ms of thread CPU time on an H100), so what is left
is time the thread sat off the CPU: waits for the interpreter lock,
which the fusion thread's host work holds, and preemption. On the H100
machines the thread CPU clock moves in 10 ms steps: one span's reading
is coarse, the mean over a window's frames is not biased."""

UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    n = run.stopwatch_counts.get("frame_offcpu", 0)
    return run.stopwatch_totals["frame_offcpu"] / n * 1e3 if n else None
