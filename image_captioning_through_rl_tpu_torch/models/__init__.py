"""Networks of the port: policy (actor), value (critic) and the A2C pair.

Each is a set of plain functions over a parameter dict in the JAX
package's layout. The reward network and VGG16 are not ported yet.
"""

from . import a2c, policy, value
from .convert import (
    a2c_from_state_dict,
    a2c_to_state_dict,
    from_jax_params,
    load_state_dict,
    policy_from_state_dict,
    policy_to_state_dict,
    value_from_state_dict,
    value_to_state_dict,
)

__all__ = [
    "a2c",
    "policy",
    "value",
    "from_jax_params",
    "load_state_dict",
    "policy_from_state_dict",
    "policy_to_state_dict",
    "value_from_state_dict",
    "value_to_state_dict",
    "a2c_from_state_dict",
    "a2c_to_state_dict",
]
