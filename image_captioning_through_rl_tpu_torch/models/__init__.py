"""Networks of the port: policy (actor), value (critic) and the A2C pair.

Each is a set of plain functions over a parameter dict in the JAX
package's layout, plus the reward network (the learned VSE reward). VGG16
is not ported yet.
"""

from . import a2c, policy, reward, value
from .convert import (
    a2c_from_state_dict,
    a2c_to_state_dict,
    from_jax_params,
    load_state_dict,
    network_from_state_dict,
    network_to_state_dict,
    policy_from_state_dict,
    policy_to_state_dict,
    reward_from_state_dict,
    reward_to_state_dict,
    value_from_state_dict,
    value_to_state_dict,
)

__all__ = [
    "a2c",
    "policy",
    "reward",
    "value",
    "from_jax_params",
    "load_state_dict",
    "policy_from_state_dict",
    "policy_to_state_dict",
    "value_from_state_dict",
    "value_to_state_dict",
    "a2c_from_state_dict",
    "a2c_to_state_dict",
    "reward_from_state_dict",
    "reward_to_state_dict",
    "network_from_state_dict",
    "network_to_state_dict",
]
