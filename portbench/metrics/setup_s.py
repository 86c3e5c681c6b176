"""Process start to the first measured request: imports, inputs made on
the device, kernels built or loaded, warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
