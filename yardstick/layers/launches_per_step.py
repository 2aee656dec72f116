"""Device operations (kernels, copies, sets) per update in the traced
window: what the host queues for one update."""


def read(view, info, spec):
    if not view.ops or not info.steps:
        return None
    return len(view.ops) / info.steps
