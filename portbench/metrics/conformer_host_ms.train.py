"""The host's mean time a micro-step in the program's span
``avsr.conformer`` (both Conformer stacks' launches), over the traced
training window: the spans' total over the window's ``train.forward``
spans."""


def read(ctx):
    win = ctx["window"]
    spans = win.get("spans") if win.get("kind") == "train" else None
    if not spans:
        return None
    steps = sum(s.name == "train.forward" for s in spans)
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "avsr.conformer")
    return ns / 1e6 / steps if steps and ns else None
