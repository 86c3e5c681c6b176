"""Map queries completed over the whole measured window (host clock)."""


def read(ctx):
    return ctx.window.units / ctx.window.seconds
