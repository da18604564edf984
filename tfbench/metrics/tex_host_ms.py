"""tex_host_ms: the program's STOPWATCH span `tex_host` (the host work
of one texture cycle's consume, TextureManager._consume on the fusion
thread, and in finish()'s catch-up on the tracking thread: the atlas
blits, the uv and label bookkeeping, the poisoning, the carry-over) per
consume, host ms, over the window less the traced stretch. A program
without the span reads None."""

UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    n = run.stopwatch_counts.get("tex_host", 0)
    return run.stopwatch_totals["tex_host"] / n * 1e3 if n else None
