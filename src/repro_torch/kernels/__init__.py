"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the backend dispatch (``ops``)."""
