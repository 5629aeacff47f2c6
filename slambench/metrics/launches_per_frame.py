"""Device: kernels launched on the card per frame of the traced window,
from the torch.profiler trace (copies and fills not counted)."""

from slambench.tracer import is_kernel


def read(ctx):
    if not hasattr(ctx, "events") or not ctx.frames:
        return None
    return sum(1 for n, _, _ in ctx.events if is_kernel(n)) / ctx.frames
