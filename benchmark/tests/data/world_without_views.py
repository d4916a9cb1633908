"""A world module that lacks ``views``, which the registry refuses."""

from benchmark.world import build_world  # noqa: F401
