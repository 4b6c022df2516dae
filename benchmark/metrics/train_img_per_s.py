"""Trained images a second: the images of every step in the window, each
ending in the optimizer's update and a synchronise, over the window's
seconds, on the host's clock."""

UNIT = "img/s"


def read(run):
    if not run.items or run.window_s <= 0:
        return None
    return sum(it["images"] for it in run.items) / run.window_s
