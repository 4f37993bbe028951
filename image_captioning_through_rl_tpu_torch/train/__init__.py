"""Training of the port: the reward, policy and value pretrainers
(counterpart of the JAX package's ``train/``). A2C is not ported yet."""
