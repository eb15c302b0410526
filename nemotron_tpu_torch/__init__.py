"""nemotron_tpu_torch: the PyTorch/CUDA port of the nemotron-speech
streaming ASR engine, for one NVIDIA H100.

A package of its own beside `nemotron_tpu` (the JAX reference, which it
never imports). Slice 1 covers the streaming main path: GGUF load ->
log-mel -> cache-aware encoder (fused ring-attention and Q8_0 matmul CUDA
kernels) -> greedy RNN-T -> text, and the streaming CLI
(`python -m nemotron_tpu_torch.cli`); later slices add the W8A8 tier, the
full-utterance path, the ServingEngine and the network server
(`python -m nemotron_tpu_torch.asr_server`), session and engine snapshots,
int4 K/V rings, per-layer right context and SmoothQuant. Entry points run
on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
