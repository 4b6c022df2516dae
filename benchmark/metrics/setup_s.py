"""Set-up seconds: from the start of the process to the first timed
request or step (weights made on the device, the kernels' library loaded
or built, the pool of requests built, the warm-up on the cell's shapes)."""

UNIT = "s"


def read(run):
    return run.setup_s
