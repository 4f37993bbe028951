"""Training of the port: the reward, policy and value pretrainers and A2C
(counterpart of the JAX package's ``train/``)."""
