"""PyTorch/CUDA port of the TapirXLA reproduction (the JAX package
``repro`` is the reference).  Slice 1: slot-paged serving of the dense GQA
transformer through the ported region compiler, with a hand-written Hopper
fused-epilogue GEMM."""
