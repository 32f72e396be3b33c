"""relation_tpu_torch: the PyTorch / CUDA port of relation_tpu, for one
NVIDIA H100. Plain tensor code is PyTorch; each Pallas kernel of the JAX
package on the ported path is a hand-written CUDA kernel (csrc/), built on
first use, with a plain PyTorch version beside it for CPU tensors. The JAX
package relation_tpu is the reference and is not imported here."""
