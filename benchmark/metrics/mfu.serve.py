"""The forward's needed operations (benchmark/harness/flops.py: valid
tokens, causal pairs, valid masks) of the window's requests over their
seconds, as a share of the H100's 989 TFLOP/s dense bf16 peak (%).  The
profiled stretch is left out of both."""

UNIT = "%"


def read(run):
    return run.mfu(backward=False)
