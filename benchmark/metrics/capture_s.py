"""compiled program: seconds the programs built in set-up took to warm up
and capture (``report()["capture_s"]`` of the sampler's ``HeunProgram``s or
the trainer's ``StepProgram``s); nothing where no graph was captured."""
UNIT = "s"


def read(ctx):
    return ctx["built"].get("capture_s") or None
