"""setup_s: process start to the first timed request (build, inputs,
warm-up), host clock, seconds."""


def read(ctx):
    return ctx.setup_s
