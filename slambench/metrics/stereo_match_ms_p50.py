"""Stereo (`ops/stereo.py`): the median time of a synchronised
`stereo_match` call, one per stereo frame of the synchronous path (inside
the pipelined device step a span would time its dispatch alone)."""


def read(ctx):
    spans = ctx.spans.get("stereo_match", [])
    return ctx.percentile([(e - s) / 1e6 for s, e in spans], 50) if spans else None
