"""Grounded images a second: the images of every request whose masks came
back in the window, over the window's seconds (its start to the end of its
last request), on the host's clock."""

UNIT = "img/s"


def read(run):
    if not run.items or run.window_s <= 0:
        return None
    return sum(it["images"] for it in run.items) / run.window_s
