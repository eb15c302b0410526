"""nemotron_tpu_torch: the PyTorch/CUDA port of the nemotron-speech
streaming ASR engine, for one NVIDIA H100.

A package of its own beside `nemotron_tpu` (the JAX reference, which it
never imports), and everything that package does: GGUF load -> log-mel
-> cache-aware encoder (fused ring-attention, Q8_0 and W8A8 matmul CUDA
kernels) -> greedy, beam, TDT or CTC decode -> text, through the
streaming and batch CLIs (`python -m nemotron_tpu_torch.cli`,
`cli_transcribe`), sessions, the ServingEngine and LockstepEngine, the
network server (`python -m nemotron_tpu_torch.asr_server`), snapshots,
the quant tiers, training (`train`, `train_lm`), a (data, model) mesh of
ranks (`serve --mesh`), dump tracing and profiles (`cli --trace`,
`--profile`), and the native C++ GGUF loader and DSP frontend built from
`native/`. Entry points run on the card unless the caller asks for the
CPU.
"""

__version__ = "0.1.0"
