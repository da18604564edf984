"""setup_s: from the start of the process to the start of the measured
window: imports, the device, the kernels' build (on a checkout's first
run), rendering the clean frames, and the warm session (the benchmark's
own clock)."""

UNIT = "s"


def read(run):
    return run.setup_s
