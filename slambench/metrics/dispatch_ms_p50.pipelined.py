"""Pipelined facade (`track_*_pipelined`, `slam/pipeline.py`): the median
host time of a pipelined call that does not drain."""


def read(ctx):
    if ctx.entry != "pipelined":
        return None
    own = [(e - s) / 1e6 for s, e, drained in ctx.frame_spans if not drained]
    return ctx.percentile(own, 50) if own else None
