"""Networks of the port: policy (actor), value (critic) and the A2C pair.

Each is a set of plain functions over a parameter dict in the JAX
package's layout, plus the reward network (the learned VSE reward), and
the visual front ends: VGG16 (an ``nn.Module`` in torchvision's layout) and
CLIP's ViT image tower (``vit``, in OpenAI CLIP's layout).
"""

from . import a2c, policy, reward, value, vgg, vit
from .convert import (
    a2c_from_state_dict,
    a2c_to_state_dict,
    clip_vision_from_state_dict,
    clip_vision_to_state_dict,
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
    vgg_from_jax,
    vgg_from_state_dict,
    vgg_to_jax,
)

__all__ = [
    "a2c",
    "policy",
    "reward",
    "value",
    "vgg",
    "vit",
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
    "vgg_from_state_dict",
    "vgg_from_jax",
    "vgg_to_jax",
    "clip_vision_from_state_dict",
    "clip_vision_to_state_dict",
]
