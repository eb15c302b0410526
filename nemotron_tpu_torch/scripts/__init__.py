"""The port's evaluation and parity entry points, one module for each JAX
script of the same name under `scripts/`: each runs as
`python -m nemotron_tpu_torch.scripts.NAME`, takes that script's flags and
prints its lines and JSON keys, runs on the CUDA card unless --cpu is
given, and exposes `main(argv) -> int` for in-process callers.

  token_agreement   quantized configurations against dense f32 (agreement,
                    flips, TER on the tones fixtures)
  compare_outputs   streaming against batch transcripts (the quality gate)
  emission_delay    per-token emission delay by latency mode
  beam_quality      greedy against beam TER
  lm_quality        greedy / beam / beam+LM TER on grammar streams
  tdt_quality       TDT against RNN-T TER and decode iterations
  hybrid_quality    RNN-T against CTC TER on a hybrid checkpoint
  refine_quality    online greedy with endpointing against offline
                    refinement
  analyze_streaming cache geometry and state budget of each latency mode
  gen_mel           a mel dump from PCM
  export_layer_data a traced session's dumps as .npy
  compare_tensors   diff of two dumps or dump directories
  layer_flamechart  a GGUF's tensor sizes as an HTML treemap
  compare_layers    per-stage diff of the torch model against the numpy
                    oracle (nemotron_tpu_torch.oracle)
  debug_conv_layers every internal stage of the subsampling and of one
                    conformer conv module against the oracle
  debug_joint_trace the greedy label loop, step by step, against the
                    oracle up to the first divergence
  run_parity        the parity ladder: load, stages, greedy, streaming,
                    quant tiers, expected / reference transcripts
  convert_to_gguf   a NeMo .nemo or checkpoint to GGUF
  convert_weights   the NEMO bin format to and from checkpoints and GGUFs

_common holds what they share; sharing_loads (from it) lets the oracle
tools run one after another in a process share one load of a GGUF.
"""

from ._common import sharing_loads

__all__ = ["sharing_loads"]
