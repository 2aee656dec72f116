"""Device-idle milliseconds per update in the gaps that open while the
caller's thread is inside a span named with one of the prefixes
``spec["spans"]``: a gap is named 'span / op' by the innermost span and op
open on that thread when it begins (``TraceView.gaps``), and it counts where
that span's name starts with a prefix.

None where no device operation of the slice was launched inside
``train.forward``: the program opens no spans of its update. Otherwise a
number, 0.0 where no gap opened inside those spans."""

INSTRUMENTED = "train.forward"


def read(view, info, spec):
    if not info.steps or not any(INSTRUMENTED in op.ancestors for op in view.ops):
        return None
    prefixes = tuple(spec["spans"])
    sec = sum(s for name, s in view.gaps if name.split(" / ", 1)[0].startswith(prefixes))
    return 1e3 * sec / info.steps
