"""PyTorch/CUDA port of `tpu_tts` for NVIDIA Hopper.

Mirrors the layout of `tpu_tts/`; the JAX package stays the reference and
nothing here imports it. Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"
