"""Host time in the program's ``procgen_torch.refill`` spans (levelgen and
the static bake of the pregenerated levels) over the traced window."""


def read(run):
    return run.trace.share("procgen_torch.refill")
