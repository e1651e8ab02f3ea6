"""The whole transcription batch's share of the card's bf16 peak."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "transcribe")
