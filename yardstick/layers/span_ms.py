"""Device milliseconds per update of the operations launched inside a span
named with one of the prefixes ``spec["spans"]``, leaving out those also
launched inside one named with a prefix of ``spec.get("except", [])``.
None where no operation was."""


def read(view, info, spec):
    spans, skip = tuple(spec["spans"]), tuple(spec.get("except", ()))

    def inside(op):
        return (any(a.startswith(spans) for a in op.ancestors)
                and not any(a.startswith(skip) for a in op.ancestors))

    sec = view.seconds(inside)
    if sec == 0.0 or not info.steps:
        return None
    return 1e3 * sec / info.steps
