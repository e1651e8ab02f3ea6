"""MB of relative-position score tensors the program's forwards
materialised (its counter ``avsr.relpos_bytes``) over the segments the
traced training window trained."""


def read(ctx):
    win = ctx["window"]
    if win.get("kind") != "train" or not win.get("segments"):
        return None
    n = (win.get("counters") or {}).get("avsr.relpos_bytes")
    return n / 1e6 / win["segments"] if n else None
