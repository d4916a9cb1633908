"""A stand-in module of a package the registry refuses: it imports the
shared reference absolutely, where a copy imports its own modules
relatively."""

from benchmark.reference.hit import closest_hit  # noqa: F401
