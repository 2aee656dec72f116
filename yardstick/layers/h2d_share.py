"""The share of the device's busy time spent copying host memory to the
device (``Memcpy HtoD``, pageable or pinned)."""


def read(view, info, spec):
    sec = view.seconds(lambda op: op.cat == "gpu_memcpy" and "HtoD" in op.name)
    if sec == 0.0 or view.busy_s == 0.0:
        return None
    return 100.0 * sec / view.busy_s
