"""PyTorch/CUDA port of the ``repro`` package: relocatable distributed
collections whose relocation windows and GLB steal loop run on an
NVIDIA card, with the relocation codec in hand-written CUDA kernels
(``repro_torch.kernels``)."""
