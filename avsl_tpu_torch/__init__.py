"""AVSL in PyTorch and CUDA for NVIDIA Hopper: the port of ``avsl_tpu``.

It serves Whisper and audio-visual Whisper-Flamingo (the AV-HuBERT video
tower and tanh-gated cross-attention) with greedy decoding
(``infer.StreamingTranscriber``) and fine-tunes audio-only Whisper
(``cli.whisper_ft`` over ``train``). The flash-attention forward and
backward are hand-written CUDA kernels (``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu``). The package imports ``torch``, numpy and the
standard library only; entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
