"""A training step's needed operations (the forward's, plus two products
per forward product of the trained heads for their backward) of the
window's steps over their seconds, as a share of the 989 TFLOP/s dense
bf16 peak (%).  The profiled stretch is left out of both."""

UNIT = "%"


def read(run):
    return run.mfu(backward=True)
