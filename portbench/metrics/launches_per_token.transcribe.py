"""Device kernels launched in the traced transcription window over the
tokens it served (segments x new tokens)."""

from portbench import readers


def read(ctx):
    return readers.launches_per(ctx, "transcribe", "tokens")
