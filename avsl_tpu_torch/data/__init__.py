"""Host-side data helpers of the port: tokenizers and wav ingest."""

from avsl_tpu_torch.data.audio_segments import load_wav, pcm_to_float
from avsl_tpu_torch.data.tokenizer import (
    BPETokenizer,
    ByteTokenizer,
    Tokenizer,
    get_tokenizer,
)

__all__ = [
    "BPETokenizer",
    "ByteTokenizer",
    "Tokenizer",
    "get_tokenizer",
    "load_wav",
    "pcm_to_float",
]
