"""Set-up: from the start of the process to the start of the window
(imports, the kernels' build where the checkout has none, weights and
inputs, warm-up), host clock."""


def read(ctx):
    return ctx.setup_s
