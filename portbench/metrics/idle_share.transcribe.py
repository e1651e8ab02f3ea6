"""The share of the traced transcription window in which the device ran nothing."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "transcribe")
