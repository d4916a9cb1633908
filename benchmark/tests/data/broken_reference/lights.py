"""A stand-in module of a package the registry refuses."""
