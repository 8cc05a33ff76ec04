"""setup_s: process start to the window's opening (model, state, traffic,
warm-up), by the host's clock."""


def read(ctx):
    return ctx.setup_s
