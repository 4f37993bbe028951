"""Tensor ops of the port: matmul helpers, the LSTM cell and scan, and the
decode kernels with their plain PyTorch versions.

``fused_decode``, ``fused_beam``, ``fused_lstm``, ``fused_gru``,
``fused_rollout`` and ``fused_sample`` are the counterparts of the JAX
package's ``pallas_*`` modules; ``fused_conv_epilogue`` (VGG16's bias, ReLU
and pool after each cuDNN convolution) has none. Their CUDA sources are in
``csrc/`` and build through ``kernel_build`` on first use.
"""
