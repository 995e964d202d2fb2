"""CoSA co-training in PyTorch for one NVIDIA H100 (Hopper).

A port of the JAX package ``cosa_tpu`` that imports nothing of it: the
hot kernels (fused attention, the RFF embedding) are hand-written CUDA in
``csrc/``, everything else is plain PyTorch.
"""
