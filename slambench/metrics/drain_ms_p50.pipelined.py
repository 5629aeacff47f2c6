"""Drain (`SlamSystem._drain_batch`: the ring read, `mapping_prep` per
keyframe, the deferred local BA, the tracking-set refresh): its median
host time, unsynchronised so that the trace keeps the pipeline's overlap
(the ring read waits for the frames the drain decides)."""


def read(ctx):
    spans = ctx.spans.get("drain", [])
    if ctx.entry != "pipelined" or not spans:
        return None
    return ctx.percentile([(e - s) / 1e6 for s, e in spans], 50)
