"""Serving path of the port."""

from avsl_tpu_torch.infer.pipeline import StreamingTranscriber, TranscribeResult

__all__ = ["StreamingTranscriber", "TranscribeResult"]
