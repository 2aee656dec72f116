"""The whole step's share of the chips' peak: the model FLOP of the frozen
formulas (``yardstick/flops.py``) for the items done in the traced window,
over the window's length, over the peak of the configuration's arithmetic
times the number of chips."""


def read(view, info, spec):
    if not info.items or not info.peaks:
        return None
    rate = info.flop_per_item * info.items / view.window_s
    return 100.0 * rate / (info.peaks["flops"][info.arithmetic] * info.chips)
