"""setup_s (s, host clock): from the start of the run's process to the
start of the window: imports, the port's libraries built or loaded, the
inputs made from the seed and the warm-up jobs."""


def read(ctx):
    return ctx.setup_s
