"""The benchmark's plain reference: frozen copies of the program's plain
PyTorch integrator and what it needs, importing nothing of the program."""
