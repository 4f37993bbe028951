"""Tensor ops of the port: matmul helpers, the LSTM cell and scan, and the
decode kernels with their plain PyTorch versions.

``fused_decode`` and ``fused_beam`` are the counterparts of the JAX
package's ``pallas_decode`` and ``pallas_beam``; their CUDA sources are in
``csrc/`` and build through ``kernel_build`` on first use.
"""
