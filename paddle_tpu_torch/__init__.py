"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for an NVIDIA H100.

The JAX package `paddle_tpu` stays the reference; this package imports
nothing from it and nothing of JAX. Each Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper (`kernels/csrc/`), beside a
plain PyTorch version that runs on the CPU. Ported so far: GPT-2 serving
(`inference/engine.py::DecodeEngine` over `models/gpt.py`'s paged decode
and prefill steps, with the JAX engine's request lifecycle and in-flight
readback window; `testing/faults.py` holds its fault sites), native or
quantized (int8 KV pages, weight-only int8:
`quantization/`), GPT-2 training (`train/scan_step.py`), and the
`incubate.nn` fused layers (`incubate/nn/`: the fused layernorm and rotary
kernels, over the Paddle nn layers of `nn/`). With them every Pallas
kernel of the JAX package has its Hopper counterpart: ten kernels.
"""
