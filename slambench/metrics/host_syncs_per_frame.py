"""Facade: the host's waits on the card per frame of the window, counted
by CUDA's sync debug mode (the spans' own synchronisations left out)."""


def read(ctx):
    if ctx.waits is None or not ctx.frames:
        return None
    return ctx.waits / ctx.frames
