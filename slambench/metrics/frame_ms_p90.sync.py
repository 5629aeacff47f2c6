"""Facade (`slam/system.py`): the 90th percentile of the host time of a
synchronous `track_*` call, each frame between two synchronisations."""


def read(ctx):
    if ctx.entry != "sync" or not ctx.frame_spans:
        return None
    return ctx.percentile([(e - s) / 1e6 for s, e, _ in ctx.frame_spans], 90)
