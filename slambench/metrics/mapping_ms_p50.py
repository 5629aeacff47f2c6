"""Mapping (`slam/mapping.py`): the median time of a synchronised
`mapping_step` (cull, triangulation and fusion through K3, local BA
through K4, keyframe cull), one per keyframe of the synchronous path."""


def read(ctx):
    spans = ctx.spans.get("mapping", [])
    return ctx.percentile([(e - s) / 1e6 for s, e in spans], 50) if spans else None
