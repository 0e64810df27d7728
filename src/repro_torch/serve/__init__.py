"""LM serving: the continuous-batching ``Engine`` and token sampling."""

from .engine import Engine, Request  # noqa: F401
from .sampling import sample  # noqa: F401
