"""Device (H100): the share of the traced window in which no operation ran
on the card, from the torch.profiler trace."""


def read(ctx):
    if not hasattr(ctx, "busy_s") or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
