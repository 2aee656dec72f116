"""The share of the traced window in which no operation ran on the device."""


def read(view, info, spec):
    return 100.0 * (view.window_s - view.busy_s) / view.window_s
