"""One driver per traffic kind: ``setup(ctx)``, ``window(state, seconds)``
and ``check(state)`` (see ``run.py``)."""
