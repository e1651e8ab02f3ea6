"""AVSL in PyTorch and CUDA for NVIDIA Hopper: the port of ``avsl_tpu``.

Slice 1 serves audio-only Whisper greedy transcription
(``infer.StreamingTranscriber``); the flash-attention forward is a
hand-written CUDA kernel (``csrc/flash_attn_fwd.cu``). The package imports
``torch``, numpy and the standard library only; entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
