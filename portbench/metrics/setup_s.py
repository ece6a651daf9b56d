"""Set-up: from the start of the run's process to the start of the window:
imports, the pipeline with its weights on the card, the voices' clips (and
the fast pipeline's latents a voice), the kernels' build where the checkout
has none, and one warm request."""


def read(ctx):
    return ctx.setup_s
