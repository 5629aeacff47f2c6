"""Headless visualization: map/trajectory renders without a GL stack.

A copy of ``ydorbslam_tpu/viz/headless.py`` (numpy and PIL only) that
also takes the port's card tensors: every array it draws is read to the
host through ``.cpu()`` (``_host``), only the map fields a render draws,
and only on a frame it draws.

The reference's Viewer/FrameDrawer/MapDrawer (src/viewer.cpp,
src/frameDrawer.cpp, src/mapDrawer.cpp) render live through Pangolin +
OpenCV HighGUI.  A TPU host is headless, so visualization here is
offline PNG rendering via PIL: a top-down map view (points, keyframe
frusta footprint, covisibility edges, trajectory) and an annotated
frame view (tracked keypoints + status bar) — the same information,
file-based.  Not a correctness dependency (the reference also runs with
the viewer off, src/system.hpp:41).
"""
from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """A numpy copy of a tensor on any device, or of an array."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _topdown_projector(points: np.ndarray, size: int, margin: float = 0.05):
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    pad = span * margin
    lo, hi = lo - pad, hi + pad
    scale = (size - 1) / np.maximum(hi - lo, 1e-6)
    s = min(scale[0], scale[1])

    def to_px(p):
        x = (p[..., 0] - lo[0]) * s
        y = (p[..., 1] - lo[1]) * s
        return x.astype(np.int32), (size - 1 - y).astype(np.int32)

    return to_px


def render_map_topdown(
    map_state,
    path: str,
    size: int = 1024,
    axes=(0, 2),
) -> None:
    """Top-down (default x-z) map render: points, keyframes, covis edges.

    Covers MapDrawer::drawMapPoints/drawKeyFrames (src/mapDrawer.cpp):
    map points in gray, keyframes as dots with covisibility edges, the
    spanning tree in a lighter shade.
    """
    from PIL import Image, ImageDraw

    mp_pos = _host(map_state.mp_pos)[_host(map_state.mp_valid)]
    kf_valid = _host(map_state.kf_valid)
    kf_pose = _host(map_state.kf_pose)
    centers = np.stack(
        [-kf_pose[k][:3, :3].T @ kf_pose[k][:3, 3] for k in range(len(kf_pose))]
    )
    a, b = axes
    pts2 = np.stack([mp_pos[:, a], mp_pos[:, b]], -1) if len(mp_pos) else np.zeros((0, 2))
    kfs2 = np.stack([centers[:, a], centers[:, b]], -1)
    allpts = np.concatenate([pts2, kfs2[kf_valid]], axis=0)
    if len(allpts) < 2:
        allpts = np.array([[0.0, 0.0], [1.0, 1.0]])
    img = Image.new("RGB", (size, size), (250, 250, 250))
    draw = ImageDraw.Draw(img)
    to_px = _topdown_projector(allpts, size)

    if len(pts2):
        xs, ys = to_px(pts2)
        for x, y in zip(xs, ys):
            draw.point((int(x), int(y)), fill=(110, 110, 110))

    covis = _host(map_state.covis)
    ii, jj = np.nonzero(np.triu(covis, 1) > 15)
    kx, ky = to_px(kfs2)
    for i, j in zip(ii, jj):
        if kf_valid[i] and kf_valid[j]:
            draw.line(
                (int(kx[i]), int(ky[i]), int(kx[j]), int(ky[j])),
                fill=(170, 200, 170), width=1,
            )
    parent = _host(map_state.parent)
    for k in np.where(kf_valid)[0]:
        p = parent[k]
        if p >= 0 and kf_valid[p]:
            draw.line(
                (int(kx[k]), int(ky[k]), int(kx[p]), int(ky[p])),
                fill=(90, 140, 220), width=2,
            )
    order = np.argsort(_host(map_state.kf_frame_id))
    for k in order:
        if kf_valid[k]:
            draw.ellipse(
                (int(kx[k]) - 3, int(ky[k]) - 3, int(kx[k]) + 3, int(ky[k]) + 3),
                fill=(40, 90, 200),
            )
    img.save(path)


class PeriodicViewer:
    """In-run periodic rendering — the Viewer thread's render loop
    (src/viewer.cpp:37-121) as a frame-cadence hook.

    The reference's Viewer wakes every ~30 ms and redraws the map and
    the annotated frame; on a headless host the same information is
    written as numbered PNGs every ``every`` tracked frames.  Attach via
    ``SlamSystem.attach_viewer(out_dir)``; the system calls ``maybe_draw``
    from both tracking paths.  Rendering pulls host copies of the map
    arrays, so the cadence (default 30 = ~1 Hz at TUM rates) bounds the
    overhead; it is never on the per-frame device path.
    """

    def __init__(self, out_dir: str, every: int = 30,
                 draw_frame: bool = True, draw_map: bool = True):
        import os

        self.out_dir = out_dir
        self.every = max(1, int(every))
        self.draw_frame = draw_frame
        self.draw_map = draw_map
        self.n_rendered = 0
        os.makedirs(out_dir, exist_ok=True)

    def maybe_draw(self, system, frame_id: int, gray=None) -> bool:
        if frame_id % self.every:
            return False
        import os

        if self.draw_frame and gray is not None:
            kps = system.tracked_keypoints()
            if kps is not None:
                uv, valid = kps
                # green = bound to a map point, blue = detected only
                mpid = getattr(system, "_frame_mpid", None)
                matched = (
                    _host(mpid) >= 0 if mpid is not None
                    else np.zeros(len(uv), bool)
                )
                uv, matched = uv[valid], matched[valid]
            else:  # no frame tracked yet
                uv = np.zeros((0, 2), np.float32)
                matched = np.zeros((0,), bool)
            txt = (f"f{frame_id} {system.tracking_state().name} "
                   f"KF {system.n_keyframes} "
                   f"inliers {system.tracked_map_points()}")
            render_tracked_frame(
                np.asarray(gray, np.float32), uv, matched,
                os.path.join(self.out_dir, f"frame_{frame_id:06d}.png"),
                state_text=txt,
            )
        if self.draw_map and system.n_keyframes > 0:
            render_map_topdown(
                system.map,
                os.path.join(self.out_dir, f"map_{frame_id:06d}.png"),
            )
        self.n_rendered += 1
        return True


def render_tracked_frame(
    gray: np.ndarray,
    uv: np.ndarray,
    tracked: np.ndarray,
    path: str,
    state_text: str = "",
) -> None:
    """Annotated frame: keypoints (green = map match, blue = detected
    only) + status text (FrameDrawer::drawFrame/drawTextInfo)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.clip(gray, 0, 255).astype(np.uint8)).convert("RGB")
    draw = ImageDraw.Draw(img)
    for (u, v), ok in zip(uv, tracked):
        color = (40, 220, 60) if ok else (70, 120, 230)
        draw.rectangle((u - 3, v - 3, u + 3, v + 3), outline=color)
    if state_text:
        draw.rectangle((0, img.height - 18, img.width, img.height), fill=(0, 0, 0))
        draw.text((4, img.height - 15), state_text, fill=(255, 255, 255))
    img.save(path)
