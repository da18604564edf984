"""refine_replay_share: the share of the stale-frame refinements that
replayed a captured program, over the window less the traced stretch:
the program's STOPWATCH counts `refine_replay` (a refinement whose
shapes had a program already) over `refine_replay` + `refine_capture`
(a refinement with new shapes: its eager run and its capture). A program
that captures no refinement counts neither, and the reader returns
None."""

UNIT = "fraction"
MOVES = "frames_per_s"


def read(run):
    replay = run.stopwatch_counts.get("refine_replay", 0)
    n = replay + run.stopwatch_counts.get("refine_capture", 0)
    return replay / n if n else None
