"""The port's model zoo (this slice: GPT)."""

from .convert import gpt_params_to_jax, gpt_params_from_jax  # noqa: F401
from .gpt import GPT, GPT_SMALL, GPT_TINY, GPTConfig, lm_loss  # noqa: F401
