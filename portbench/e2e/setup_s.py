"""setup_s: from the start of the process to the opening of the window:
imports, the card's context, building or loading the kernels, the inputs
and weights, recording, and warming up every shape the cell uses (host
clock)."""


def read(run):
    return run.setup_s
