"""Serving path of the port."""

from avsl_tpu_torch.infer.export import export_serving_program, load_exported
from avsl_tpu_torch.infer.longform import LongFormResult, LongSegment
from avsl_tpu_torch.infer.pipeline import StreamingTranscriber, TranscribeResult
from avsl_tpu_torch.infer.server import TranscriptionServer
from avsl_tpu_torch.infer.streaming import StreamingSession

__all__ = [
    "LongFormResult",
    "LongSegment",
    "StreamingSession",
    "StreamingTranscriber",
    "TranscribeResult",
    "TranscriptionServer",
    "export_serving_program",
    "load_exported",
]
