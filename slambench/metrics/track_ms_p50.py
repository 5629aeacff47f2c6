"""Tracker (`slam/tracking.py`): the median self time of a synchronised
`Tracker.track_rgbd` / `track_stereo` call: extraction, matching, the pose
solves and the local-map hook, without the `mapping_step` calls inside it."""


def read(ctx):
    tracks, maps = ctx.spans.get("track", []), ctx.spans.get("mapping", [])
    if not tracks:
        return None
    own = [(e - s - sum(me - ms for ms, me in maps if s <= ms and me <= e)) / 1e6
           for s, e in tracks]
    return ctx.percentile(own, 50)
