"""SplaTAM in PyTorch + CUDA: the online RGB-D SLAM loop on an NVIDIA GPU.

Port of the JAX package `splatam_tpu` (kept beside it as the reference).
Module paths mirror the reference package; the four Pallas kernels of the
main path are hand-written CUDA kernels under `csrc/`, built at first use
(`render/_cuda.py`). Every kernel has a plain PyTorch version beside its
wrapper, which is what runs for tensors that live on the CPU.

f32 matmuls and convolutions stay full f32: the reference forces the same
(`splatam_tpu/__init__.py`), and cuDNN's TF32 default would run the SSIM
blur of the mapping loss at ~3 decimal digits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
