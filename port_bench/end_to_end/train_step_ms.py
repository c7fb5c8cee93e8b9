"""The window's milliseconds over the steps it finished."""


def read(run):
    return 1e3 * run.window_s / run.work["steps"]
