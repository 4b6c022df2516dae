"""The device's idle share of the profiled stretch (%): one minus the union
of the device's operation intervals over the stretch's wall seconds."""

UNIT = "%"


def read(run):
    return run.idle_pct()
