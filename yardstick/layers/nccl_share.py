"""The share of the device's busy time in NCCL's kernels (the gradient
all-reduce and the metrics' reductions)."""


def read(view, info, spec):
    sec = view.seconds(lambda op: op.cat == "kernel" and "nccl" in op.name.lower())
    if sec == 0.0 or view.busy_s == 0.0:
        return None
    return 100.0 * sec / view.busy_s
