"""A reference package the registry refuses: it lacks ``gates``, and its
``hit`` imports the shared reference absolutely."""
