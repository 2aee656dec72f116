"""Device milliseconds per step (or batch) of the operations launched under
a convolution op (``spec["ops"]``): cuDNN's forward, data- and
weight-gradient kernels and its layout conversions."""


def read(view, info, spec):
    ops = set(spec["ops"])
    sec = view.seconds(lambda op: any(a in ops for a in op.ancestors))
    if sec == 0.0 or not info.steps:
        return None
    return 1e3 * sec / info.steps
