"""Device milliseconds per update of the kernels whose names hold one of
``spec["kernels"]``.

Names, not the host ops or spans that launched them: a VQ-VAE update on a
card replays a CUDA graph, whose kernels keep their names in the device
trace but sit under no op or span of the update. ``spec["attributed"]`` is
the op-attributed reading of the same layer (a reader and its arguments),
which ``tests/test_yardstick_kernel_names.py`` holds this one against on the
card. None where no such kernel ran."""


def read(view, info, spec):
    names = spec["kernels"]
    sec = view.seconds(lambda op: op.cat == "kernel" and any(k in op.name for k in names))
    if sec == 0.0 or not info.steps:
        return None
    return 1e3 * sec / info.steps
