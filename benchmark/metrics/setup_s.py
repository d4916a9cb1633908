"""Seconds from the process's start to the window's first dispatch:
imports, the card's start, the kernel's library (compiled on a
checkout's first run), the world, the session and the warm step."""


def read(ctx):
    return ctx.window.setup_s
