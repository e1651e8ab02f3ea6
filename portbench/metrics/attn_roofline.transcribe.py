"""K1's share of its roofline in the transcription window."""

from portbench import readers


def read(ctx):
    return readers.attn_roofline(ctx, "transcribe")
