"""Offline 2D/3D debug rendering to PNG files (no GUI dependencies).

Rebuild of the reference's debug visualizers for a headless TPU appliance:
the OpenCV 2D hooks (reference: opencv_viewer_data_publisher.cpp —
keyframe-with-tracks overlay, ORB keypoint display, match drawing,
map-point-search view) and the core value of the Pangolin 3D map viewer
(reference: slam_viewer.cpp — keyframe trajectory + map point cloud) are
implemented as pure-NumPy raster drawing written out with a built-in PNG
encoder (zlib only). Combine with `utils/viewer.py` JSON snapshots for
interactive externals.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# status colors (RGB) roughly matching the reference viewer's palette
COLOR_KEYPOINT = (0, 255, 0)
COLOR_TRACKED = (255, 255, 0)
COLOR_MATCH = (0, 200, 255)
COLOR_MAP_POINT = (200, 60, 60)
COLOR_TRAJ = (40, 120, 255)
COLOR_ODOM = (150, 150, 150)
COLOR_COVIS = (60, 90, 60)
COLOR_LOOP_EDGE = (255, 60, 255)
# loop-stage palette (reference: slam_viewer.cpp loop-stage coloring;
# stages from mapdb LoopStage)
STAGE_COLORS = {
    0: (120, 120, 120),   # BOW_MATCH
    1: (230, 230, 60),    # QUICK_TESTS
    2: (255, 160, 40),    # MAP_POINT_MATCHES
    3: (60, 255, 60),     # ACCEPTED
    4: (60, 200, 255),    # RELOCATION_MAP_POINT_MATCHES
    5: (160, 60, 255),    # RELOCATION_MAP_POINT_RANSAC
}


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as PNG (pure python + zlib)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    assert c == 3
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def draw_points(img: np.ndarray, pts: np.ndarray, color=COLOR_KEYPOINT,
                radius: int = 2) -> None:
    """Draw filled circles in place."""
    h, w = img.shape[:2]
    for p in np.asarray(pts).reshape(-1, 2):
        x, y = int(round(float(p[0]))), int(round(float(p[1])))
        if not (0 <= x < w and 0 <= y < h):
            continue
        y0, y1 = max(0, y - radius), min(h, y + radius + 1)
        x0, x1 = max(0, x - radius), min(w, x + radius + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        mask = (yy - y) ** 2 + (xx - x) ** 2 <= radius * radius
        img[yy[mask], xx[mask]] = color


def draw_line(img: np.ndarray, p0, p1, color=COLOR_MATCH) -> None:
    """Bresenham-ish line via dense interpolation."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.clip(np.rint(np.linspace(x0, x1, n)).astype(int), 0, w - 1)
    ys = np.clip(np.rint(np.linspace(y0, y1, n)).astype(int), 0, h - 1)
    img[ys, xs] = color


def render_keyframe_overlay(image: np.ndarray, kf, map_db=None) -> np.ndarray:
    """Keyframe view: all keypoints, tracked ones highlighted, map-point
    observations marked (reference: visualizeKeyframe)."""
    img = to_rgb(image)
    draw_points(img, kf.shared.pts, COLOR_KEYPOINT, radius=1)
    tracked_idx = [int(k) for k in kf.keypoint_to_track]
    if tracked_idx:
        draw_points(img, kf.shared.pts[tracked_idx], COLOR_TRACKED, radius=2)
    with_mp = np.where(kf.map_points >= 0)[0]
    if len(with_mp):
        draw_points(img, kf.shared.pts[with_mp], COLOR_MAP_POINT, radius=2)
    return img


def render_matches(image1: np.ndarray, pts1: np.ndarray,
                   image2: np.ndarray, pts2: np.ndarray,
                   pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Side-by-side match drawing (reference: showMatches /
    cv::drawMatches, opencv_viewer_data_publisher.cpp:295)."""
    img1 = to_rgb(image1)
    img2 = to_rgb(image2)
    h = max(img1.shape[0], img2.shape[0])
    w1 = img1.shape[1]
    canvas = np.zeros((h, w1 + img2.shape[1], 3), np.uint8)
    canvas[:img1.shape[0], :w1] = img1
    canvas[:img2.shape[0], w1:] = img2
    for i, j in pairs:
        p1 = pts1[int(i)]
        p2 = pts2[int(j)] + np.array([w1, 0.0])
        draw_line(canvas, p1, p2, COLOR_MATCH)
        draw_points(canvas, p1[None], COLOR_TRACKED, 2)
        draw_points(canvas, p2[None], COLOR_TRACKED, 2)
    return canvas


COLOR_ATLAS = (230, 230, 230)     # reference draws atlas frusta in theme.fg


def _atlas_tracks(atlas, atlas_controls, ax):
    """Per-map atlas keyframe tracks with the reference's layout applied.

    Replicates slam_viewer.cpp:122-161 + 421-428: auto offsets place maps in
    two rows spaced 1.5x the largest keyframe bounding box; each map also
    carries user alignment controls (angle, x, y) — angle rotates the map by
    angle*pi in the viewing plane, x/y translate it (Viewer::atlasOffset).
    ``atlas`` entries are ViewerDataPublisher.set_atlas dicts. Returns
    [(map_ind, kf_ids, centers (N, 3), forwards (N, 3))]."""
    entries = []
    d_max = np.zeros(2)
    for m in atlas:
        kf_ids, centers, fwds = [], [], []
        for kf in m.get("keyframes", []):
            pose_wc = np.asarray(kf["poseWC"], float)
            kf_ids.append(int(kf["id"]))
            centers.append(pose_wc[:3, 3])
            fwds.append(pose_wc[:3, :3] @ np.array([0.0, 0.0, 1.0]))
        centers = np.array(centers).reshape(-1, 3)
        fwds = np.array(fwds).reshape(-1, 3)
        if len(centers) > 1:
            d = centers[:, ax].max(axis=0) - centers[:, ax].min(axis=0)
            d_max = np.maximum(d_max, d)
        entries.append((kf_ids, centers, fwds))
    off_auto = 1.5 * d_max
    out = []
    for map_ind, (kf_ids, centers, fwds) in enumerate(entries):
        angle, cx, cy = (atlas_controls[map_ind]
                         if atlas_controls and map_ind < len(atlas_controls)
                         else (0.0, 0.0, 0.0))
        if angle:
            # in-plane rotation by angle*pi (reference rotates poseWC about
            # the view-up axis before offsetting)
            c, s = np.cos(angle * np.pi), np.sin(angle * np.pi)
            rot = np.array([[c, -s], [s, c]])
            centers = centers.copy()
            fwds = fwds.copy()
            centers[:, list(ax)] = centers[:, ax] @ rot.T
            fwds[:, list(ax)] = fwds[:, ax] @ rot.T
        n = map_ind + 1
        offset = np.array([(n % 2) * off_auto[0] + cx,
                           (n // 2) * off_auto[1] + cy])
        centers = centers.copy()
        centers[:, list(ax)] = centers[:, ax] + offset
        out.append((map_ind, kf_ids, centers, fwds))
    return out


def render_map_orthographic(map_db, plane: str = "xz", size: int = 800,
                            margin: float = 0.07,
                            covisibility: bool = True,
                            min_covisibilities: int = 15,
                            atlas=None, atlas_controls=None) -> np.ndarray:
    """Top-down (or other plane) view of the map: point cloud, SLAM +
    odometry trajectories, covisibility-graph edges, accepted loop-closure
    edges, loop-stage keyframe coloring, and frustum heading ticks — the
    headless counterpart of the reference Pangolin viewer's map pane
    (slam_viewer.cpp:27-63: frusta, covisibility edges, loop-stage colors).

    ``atlas`` (ViewerDataPublisher.set_atlas dicts) draws loaded read-only
    maps alongside the current one with the reference's two-row auto layout
    and per-map (angle, x, y) alignment controls (slam_viewer.cpp:122-161,
    287-310, 421-428); relocation loop stages recorded against an atlas
    keyframe color it like the reference's relocation highlight."""
    from slam_tpu_torch.map.map_point import MapPointStatus

    ax = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}[plane]
    pts = [mp.position for mp in map_db.map_points.values()
           if mp.status == MapPointStatus.TRIANGULATED]
    from slam_tpu_torch.geometry import se3
    kf_items = sorted(map_db.keyframes.items())
    traj = [se3.camera_center(kf.pose_cw) for _, kf in kf_items]
    odom = [se3.camera_center(kf.orig_pose_cw) for _, kf in kf_items]
    atlas_tracks = _atlas_tracks(atlas, atlas_controls, ax) if atlas else []
    atlas_pts = [c for _, _, centers, _ in atlas_tracks for c in centers]
    # framing: full extent of the trajectories, but only the 1-99 percentile
    # of the point cloud — a handful of mis-triangulated far points must not
    # squash the map into a corner (off-frame dots are simply clipped)
    lo_hi = []
    if pts:
        p = np.array(pts)[:, ax]
        lo_hi.append((np.percentile(p, 1, axis=0),
                      np.percentile(p, 99, axis=0)))
    tracks = traj + odom + atlas_pts
    if tracks:
        t = np.array(tracks)[:, ax]
        lo_hi.append((t.min(axis=0), t.max(axis=0)))
    if not lo_hi:
        lo_hi.append((np.zeros(2), np.zeros(2)))
    lo = np.min([l for l, _ in lo_hi], axis=0)
    hi = np.max([h for _, h in lo_hi], axis=0)
    span = np.maximum(hi - lo, 1e-6)
    lo = lo - margin * span
    span = span * (1 + 2 * margin)

    def project(p3):
        q = (np.asarray(p3)[..., ax] - lo) / span
        return np.stack([q[..., 0] * (size - 1),
                         (1 - q[..., 1]) * (size - 1)], axis=-1)

    img = np.full((size, size, 3), 15, np.uint8)
    if pts:
        draw_points(img, project(np.array(pts)), COLOR_MAP_POINT, 1)

    centers = {kf_id: c for (kf_id, _), c in zip(kf_items, traj)}
    # covisibility-graph edges (dim, under the trajectories)
    if covisibility and len(kf_items) >= 2:
        for kf_id, kf in kf_items:
            for nb in kf.get_neighbors(map_db, min_covisibilities):
                if nb > kf_id and nb in centers:
                    draw_line(img, project(centers[kf_id]),
                              project(centers[nb]), COLOR_COVIS)
    for name, track, color in (("odom", odom, COLOR_ODOM),
                               ("slam", traj, COLOR_TRAJ)):
        if len(track) >= 2:
            proj = project(np.array(track))
            for a, b in zip(proj[:-1], proj[1:]):
                draw_line(img, a, b, color)
            draw_points(img, proj, color, 2)
    # frustum heading ticks: short segment along each camera's optical axis
    if traj:
        scale = 0.02 * float(np.max(span))
        for (kf_id, kf), c in zip(kf_items, traj):
            fwd = np.asarray(kf.pose_cw)[:3, :3].T @ np.array([0.0, 0.0, 1.0])
            draw_line(img, project(c), project(np.asarray(c) + scale * fwd),
                      COLOR_TRAJ)
    # atlas maps: keyframe tracks + heading ticks in fg color
    # (slam_viewer.cpp:287-310; atlas map-point drawing is commented out
    # in the reference, so only keyframes are rendered)
    stages = getattr(map_db, "loop_stages", {})
    if atlas_tracks:
        scale = 0.02 * float(np.max(span))
        for map_ind, kf_ids, acenters, afwds in atlas_tracks:
            proj = project(acenters)
            for a, b in zip(proj[:-1], proj[1:]):
                draw_line(img, a, b, COLOR_ATLAS)
            draw_points(img, proj, COLOR_ATLAS, 2)
            for c, f in zip(acenters, afwds):
                draw_line(img, project(c), project(c + scale * f),
                          COLOR_ATLAS)
            # relocation-stage highlight on the atlas keyframe the candidate
            # came from (reference animates RELOCATION_MAP_POINT_RANSAC)
            by_id = {k: i for i, k in enumerate(kf_ids)}
            for key, stage in stages.items():
                if (getattr(key, "map_id", None) == map_ind
                        and int(getattr(key, "kf_id", -1)) in by_id):
                    draw_points(img,
                                proj[by_id[int(key.kf_id)]][None],
                                STAGE_COLORS.get(int(stage),
                                                 (255, 255, 255)), 3)
    # loop-stage coloring of the current-map keyframes that recorded a stage
    # (atlas-map stages are drawn on the atlas tracks above; without the
    # map-id check they would mis-color a same-id current keyframe)
    from slam_tpu_torch.map.mapdb import CURRENT_MAP_ID
    for key, stage in stages.items():
        if getattr(key, "map_id", CURRENT_MAP_ID) != CURRENT_MAP_ID:
            continue
        kf_id = getattr(key, "kf_id", key)
        if kf_id in centers:
            draw_points(img, project(centers[kf_id])[None],
                        STAGE_COLORS.get(int(stage), (255, 255, 255)), 3)
    # accepted loop-closure edges on top (bright)
    for e in getattr(map_db, "loop_closure_edges", []):
        if e.kf_id1 in centers and e.kf_id2 in centers:
            draw_line(img, project(centers[e.kf_id1]),
                      project(centers[e.kf_id2]), COLOR_LOOP_EDGE)
    return img


def render_map_point_search(frame: Optional[np.ndarray], matched,
                            projected_mps, unmatched_kps,
                            size=(480, 640)) -> np.ndarray:
    """searchByProjection debug view (reference:
    opencv_viewer_data_publisher.cpp:207-246 visualizeMapPointSearch):
    orange dot = ORB keypoint with no matching map point, cyan circle =
    map-point projection with no matching ORB, white = matched ORB dot +
    map-point circle pair (drawn last so matches cover the candidates)."""
    orange = (255, 160, 30)
    cyan = (60, 220, 220)
    white = (255, 255, 255)
    img = (to_rgb(frame) if frame is not None
           else np.full((size[0], size[1], 3), 15, np.uint8))
    proj = np.asarray(projected_mps, float).reshape(-1, 2)
    if len(proj):
        draw_points(img, proj, cyan, 4)
    kps = np.asarray(unmatched_kps, float).reshape(-1, 2)
    if len(kps):
        draw_points(img, kps, orange, 2)
    for mp_px, kp_px in matched:
        draw_points(img, np.asarray(mp_px, float)[None], white, 4)
        draw_points(img, np.asarray(kp_px, float)[None], white, 2)
        draw_line(img, mp_px, kp_px, white)
    return img


def render_pyramid(pyramid) -> np.ndarray:
    """Stacked view of plain + blurred pyramid levels
    (reference: image_pyramid.cpp:47-57 debugVisualize)."""
    import numpy as _np
    w0, h0 = pyramid.sizes[0]
    canvas = _np.zeros((2 * h0, w0), _np.uint8)
    for lvl in range(pyramid.num_levels):
        w, h = pyramid.sizes[lvl]
        canvas[:h, :w] = _np.asarray(pyramid.levels[lvl]).astype(_np.uint8)[:h, :w]
        canvas[h0:h0 + h, :w] = _np.asarray(pyramid.blurred[lvl]).astype(_np.uint8)[:h, :w]
    return to_rgb(canvas)


class PngDebugPublisher:
    """Viewer-publisher companion writing PNG artifacts to a directory.

    Implements the 2D visualization hooks of the reference's
    ``ViewerDataPublisher`` interface (viewer_data_publisher.hpp:126-149) as
    files instead of windows.
    """

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._counter = 0

    def _path(self, tag: str) -> str:
        self._counter += 1
        return os.path.join(self.out_dir, f"{self._counter:05d}_{tag}.png")

    def visualize_keyframe(self, map_db, image, kf) -> str:
        path = self._path(f"kf{int(kf.id)}")
        write_png(path, render_keyframe_overlay(image, kf, map_db))
        return path

    def visualize_orbs(self, image, kf) -> str:
        img = to_rgb(image)
        draw_points(img, kf.shared.pts, COLOR_KEYPOINT, 2)
        path = self._path(f"orbs{int(kf.id)}")
        write_png(path, img)
        return path

    def show_matches(self, image1, kf1, image2, kf2, pairs, tag="match") -> str:
        path = self._path(tag)
        write_png(path, render_matches(image1, kf1.shared.pts,
                                       image2, kf2.shared.pts, pairs))
        return path

    def visualize_map_point_search(self, frame, matched, projected_mps,
                                   unmatched_kps) -> str:
        path = self._path("mp_search")
        write_png(path, render_map_point_search(frame, matched,
                                                projected_mps, unmatched_kps))
        return path

    def visualize_pyramid(self, pyramid) -> str:
        path = self._path("pyramid")
        write_png(path, render_pyramid(pyramid))
        return path

    def visualize_map(self, map_db, plane: str = "xz", atlas=None,
                      atlas_controls=None) -> str:
        path = self._path("map")
        write_png(path, render_map_orthographic(map_db, plane, atlas=atlas,
                                                atlas_controls=atlas_controls))
        return path
