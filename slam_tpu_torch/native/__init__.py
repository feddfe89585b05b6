"""Native host ops: C++ hot loops with ctypes bindings and NumPy fallbacks.

Compiled lazily on first use (g++ -O3); if no toolchain is available, pure
NumPy fallbacks keep everything working at reduced host speed. The covered
operations are exactly the ones the reference implements natively on host:
popcount Hamming distances, the medoid-descriptor scan, y-sorted radius
search, and the seeded unique-random-index arrays.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostops.cpp")
# -ffp-contract=off: the epipolar gate must evaluate double expressions in
# the same order as NumPy (no FMA contraction) so match gates agree exactly
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]
# the library is built beside the package's CUDA kernels, in the git-ignored
# build/slam_tpu_torch/, under a name keyed by the source, the flags and the
# host CPU (-march=native code must not run on another CPU model)
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "slam_tpu_torch")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform
    return platform.machine() + platform.processor()


def _lib_path() -> str:
    import hashlib
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()
                                + _cpu_model().encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libhostops-{digest}.so")


def _build(lib_path: str) -> Optional[str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    # -march=native when permitted; harmless to drop
    for extra in (["-march=native"], []):
        cmd = ["g++", *_FLAGS, *extra, _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
            return lib_path
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path):
            path = _build(path)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        required = ("hamming_matrix", "hamming_row", "hamming_argmin",
                    "medoid_descriptor", "medoid_descriptor_many",
                    "radius_search", "radius_hamming_best",
                    "match_triangulation", "match_loop_closure",
                    "match_tracker", "project_greedy_claim",
                    "triangulate_pairs", "match_triangulate_pair",
                    "create_random_array", "seed_random")
        if any(not hasattr(lib, s) for s in required):
            return None  # stale binary from before a newer op was added
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.hamming_matrix.argtypes = [u32p, ctypes.c_int64, u32p,
                                       ctypes.c_int64, i32p]
        lib.hamming_row.argtypes = [u32p, u32p, ctypes.c_int64, i32p]
        lib.hamming_argmin.argtypes = [u32p, ctypes.c_int64, u32p,
                                       ctypes.c_int64, i32p]
        lib.medoid_descriptor.argtypes = [u32p, ctypes.c_int64]
        lib.medoid_descriptor.restype = ctypes.c_int64
        lib.medoid_descriptor_many.argtypes = [
            u32p, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
        lib.radius_search.argtypes = [f32p, f32p, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_float, i64p]
        lib.radius_search.restype = ctypes.c_int64
        lib.seed_random.argtypes = [ctypes.c_uint32]
        lib.create_random_array.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                            ctypes.c_int32, i32p]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.match_triangulation.argtypes = [
            u32p, i32p, u8p, f64p, f64p, ctypes.c_int64,
            u32p, i32p, u8p, f64p, ctypes.c_int64,
            f64p, ctypes.c_int32, i64p]
        lib.match_loop_closure.argtypes = [
            u32p, i32p, u8p, ctypes.c_int64,
            u32p, i32p, u8p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int32, ctypes.c_int32, i64p]
        lib.radius_hamming_best.argtypes = [
            f32p, f32p, i64p, ctypes.c_int64, u32p, i32p,
            f32p, f32p, f32p, u32p, i32p, i32p, ctypes.c_int64,
            i64p, i32p]
        lib.project_greedy_claim.argtypes = [
            f32p, f32p, i64p, ctypes.c_int64, u32p, i32p, u8p,
            f32p, f32p, f32p, u32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_double, i64p]
        lib.match_tracker.argtypes = [
            u32p, f32p, ctypes.c_int64, u32p, f32p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int32, ctypes.c_double, i64p]
        lib.triangulate_pairs.argtypes = [
            i64p, i64p, ctypes.c_int64,
            f64p, f64p, f32p, f64p, u8p, f32p, i32p, f64p,   # current frame
            f64p, f64p, f32p, f64p, u8p, f32p, i32p, f64p,   # adjacent frame
            ctypes.c_double, f64p, ctypes.c_double, ctypes.c_double,
            f64p, u8p]
        lib.match_triangulate_pair.argtypes = [
            u32p, i32p, u8p, f64p, f32p, i32p, ctypes.c_int64,   # cur match
            u32p, i32p, u8p, f64p, f32p, ctypes.c_int64,         # adj match
            f64p, f64p, f64p, ctypes.c_int64,                    # poses, sf
            ctypes.c_double, ctypes.c_int32,                     # epi, thr
            f32p, f64p, u8p, f32p, f64p,                         # cur tri
            f32p, f64p, u8p, f32p, i32p, f64p,                   # adj tri
            ctypes.c_double, f64p, ctypes.c_double, ctypes.c_double,
            i64p, i64p, f64p, u8p]
        lib.match_triangulate_pair.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# public wrappers (native when possible, NumPy otherwise)
# ---------------------------------------------------------------------------


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    lib = get_lib()
    if lib is not None:
        out = np.empty((len(a), len(b)), np.int32)
        lib.hamming_matrix(a, len(a), b, len(b), out)
        return out
    from slam_tpu_torch.ops.hamming import hamming_matrix_host
    return hamming_matrix_host(a, b)


def hamming_row(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.uint32).reshape(8)
    b = np.ascontiguousarray(b, np.uint32)
    lib = get_lib()
    if lib is not None:
        out = np.empty(len(b), np.int32)
        lib.hamming_row(a, b, len(b), out)
        return out
    from slam_tpu_torch.ops.hamming import hamming_matrix_host
    return hamming_matrix_host(a[None], b)[0]


def hamming_argmin(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """First-minimum Hamming nearest neighbour of each row of ``a`` in ``b``
    without materializing the distance matrix. None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    out = np.empty(len(a), np.int32)
    lib.hamming_argmin(a, len(a), b, len(b), out)
    return out


def medoid_descriptor(descs: np.ndarray) -> int:
    """Index of the descriptor with the smallest median Hamming distance
    (reference: map_point.cpp:75-116, first index wins ties)."""
    descs = np.ascontiguousarray(descs, np.uint32)
    n = len(descs)
    if n == 0:
        return -1
    lib = get_lib()
    if lib is not None:
        return int(lib.medoid_descriptor(descs, n))
    from slam_tpu_torch.ops.hamming import hamming_matrix_host
    dist = hamming_matrix_host(descs, descs)
    medians = np.sort(dist, axis=1)[:, int(0.5 * (n - 1))]
    return int(np.argmin(medians))


def medoid_descriptor_many(descs_flat: np.ndarray,
                           ptr: np.ndarray) -> np.ndarray:
    """CSR-batched medoid scan: segment p owns descriptor rows
    [ptr[p], ptr[p+1]) of ``descs_flat``. Returns the medoid index WITHIN
    each segment (-1 for empty segments); one native call for all segments,
    falling back to the per-segment scan when the library is unavailable."""
    descs_flat = np.ascontiguousarray(descs_flat, np.uint32)
    ptr = np.ascontiguousarray(ptr, np.int64)
    n = len(ptr) - 1
    out = np.empty(n, np.int64)
    lib = get_lib()
    if lib is not None:
        lib.medoid_descriptor_many(descs_flat, ptr, n, out)
        return out
    for p in range(n):
        out[p] = medoid_descriptor(descs_flat[ptr[p]:ptr[p + 1]])
    return out


def radius_search(xs_sorted: np.ndarray, ys_sorted: np.ndarray,
                  qx: float, qy: float, r: float) -> np.ndarray:
    """Hit indices into the y-sorted arrays (strict circle test)."""
    lib = get_lib()
    n = len(ys_sorted)
    if lib is not None and n:
        xs = np.ascontiguousarray(xs_sorted, np.float32)
        ys = np.ascontiguousarray(ys_sorted, np.float32)
        out = np.empty(n, np.int64)
        cnt = lib.radius_search(xs, ys, n, np.float32(qx), np.float32(qy),
                                np.float32(r), out)
        return out[:cnt]
    lo = np.searchsorted(ys_sorted, qy - r, side="left")
    hi = np.searchsorted(ys_sorted, qy + r, side="right")
    dx = qx - xs_sorted[lo:hi]
    dy = qy - ys_sorted[lo:hi]
    return lo + np.where(dx * dx + dy * dy < r * r)[0]


def match_triangulation(desc1, groups1, free1, bearings1, sin_thr1,
                        desc2, groups2, free2, bearings2,
                        E12, thr_low: int) -> Optional[np.ndarray]:
    """Fused bucketed triangulation matcher (semantics of
    ops/matching.match_for_triangulation WITHOUT the angle check, which the
    caller applies). Returns (N1,) matched index array, or None when the
    native library is unavailable (caller falls back to the NumPy path)."""
    lib = get_lib()
    if lib is None:
        return None
    desc1 = np.ascontiguousarray(desc1, np.uint32)
    desc2 = np.ascontiguousarray(desc2, np.uint32)
    groups1 = np.ascontiguousarray(groups1, np.int32)
    groups2 = np.ascontiguousarray(groups2, np.int32)
    free1 = np.ascontiguousarray(free1, np.uint8)
    free2 = np.ascontiguousarray(free2, np.uint8)
    bearings1 = np.ascontiguousarray(bearings1, np.float64)
    bearings2 = np.ascontiguousarray(bearings2, np.float64)
    sin_thr1 = np.ascontiguousarray(sin_thr1, np.float64)
    E12 = np.ascontiguousarray(E12, np.float64)
    out = np.empty(len(desc1), np.int64)
    lib.match_triangulation(desc1, groups1, free1, bearings1, sin_thr1,
                            len(desc1), desc2, groups2, free2, bearings2,
                            len(desc2), E12, np.int32(thr_low), out)
    return out


def match_loop_closure(desc1, groups1, cand1, desc2, groups2, cand2,
                       lowe_ratio: float, thr_low: int,
                       max_dist: int) -> Optional[np.ndarray]:
    """Fused bucketed loop-closure matcher (semantics of
    ops/matching.match_loop_closure_descriptors WITHOUT the angle check).
    Returns (N1,) matched index array, or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    desc1 = np.ascontiguousarray(desc1, np.uint32)
    desc2 = np.ascontiguousarray(desc2, np.uint32)
    groups1 = np.ascontiguousarray(groups1, np.int32)
    groups2 = np.ascontiguousarray(groups2, np.int32)
    cand1 = np.ascontiguousarray(cand1, np.uint8)
    cand2 = np.ascontiguousarray(cand2, np.uint8)
    out = np.empty(len(desc1), np.int64)
    lib.match_loop_closure(desc1, groups1, cand1, len(desc1),
                           desc2, groups2, cand2, len(desc2),
                           float(lowe_ratio), np.int32(thr_low),
                           np.int32(max_dist), out)
    return out


def radius_hamming_best(xs_sorted, ys_sorted, order, descs, octaves,
                        qx, qy, qr, qdesc, qlvl_min=None, qlvl_max=None):
    """For each query circle: first-minimum Hamming match among keypoints
    strictly inside (scanned in y order, matching ``np.argmin`` over
    ``get_features_around`` hits), with optional per-query octave bands.
    Returns (best_idx int64 (C,), best_dist int32 (C,)); best_idx -1 and
    dist 256 when no hit. None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs_sorted, np.float32)
    ys = np.ascontiguousarray(ys_sorted, np.float32)
    order = np.ascontiguousarray(order, np.int64)
    descs = np.ascontiguousarray(descs, np.uint32)
    octaves = np.ascontiguousarray(octaves, np.int32)
    qx = np.ascontiguousarray(qx, np.float32)
    qy = np.ascontiguousarray(qy, np.float32)
    qr = np.ascontiguousarray(qr, np.float32)
    qdesc = np.ascontiguousarray(qdesc, np.uint32)
    c = len(qx)
    if qlvl_min is None:
        qlvl_min = np.full(c, -(1 << 30), np.int32)
    if qlvl_max is None:
        qlvl_max = np.full(c, 1 << 30, np.int32)
    qlvl_min = np.ascontiguousarray(qlvl_min, np.int32)
    qlvl_max = np.ascontiguousarray(qlvl_max, np.int32)
    best_idx = np.empty(c, np.int64)
    best_dist = np.empty(c, np.int32)
    lib.radius_hamming_best(xs, ys, order, len(ys), descs, octaves,
                            qx, qy, qr, qdesc, qlvl_min, qlvl_max, c,
                            best_idx, best_dist)
    return best_idx, best_dist


def project_greedy_claim(xs_sorted, ys_sorted, order, descs, octaves, owned,
                         qx, qy, qr, qdesc, thr_high: int, lowe: float):
    """Fused searchByProjection inner loop: for each query circle, greedily
    claim the best unowned keypoint (original-index scan order, best<=thr_high,
    same-octave Lowe rejection); ``owned`` (uint8) is updated in place.
    Returns matched int64 (C,) with -1 for no claim, or None when the native
    library is unavailable (caller falls back to the Python loop)."""
    lib = get_lib()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs_sorted, np.float32)
    ys = np.ascontiguousarray(ys_sorted, np.float32)
    order = np.ascontiguousarray(order, np.int64)
    descs = np.ascontiguousarray(descs, np.uint32)
    octaves = np.ascontiguousarray(octaves, np.int32)
    assert owned.dtype == np.uint8 and owned.flags.c_contiguous
    qx = np.ascontiguousarray(qx, np.float32)
    qy = np.ascontiguousarray(qy, np.float32)
    qr = np.ascontiguousarray(qr, np.float32)
    qdesc = np.ascontiguousarray(qdesc, np.uint32)
    c = len(qx)
    matched = np.empty(c, np.int64)
    lib.project_greedy_claim(xs, ys, order, len(ys), descs, octaves, owned,
                             qx, qy, qr, qdesc, c,
                             np.int32(thr_high), float(lowe), matched)
    return matched


def match_tracker(desc_cur, pts_cur, desc_prev, pts_prev,
                  max_motion: float, thr: int,
                  lowe: float) -> Optional[np.ndarray]:
    """Fused frame-to-frame tracker matching (NumPy twin:
    frontends/descriptor_tracker._match_to_prev_numpy). For each current
    keypoint: best/second Hamming among previous keypoints within the motion
    radius, absolute + Lowe gates, mutual-best check. Returns (N,) int64
    previous-index array with -1 for no match, or None when the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    desc_cur = np.ascontiguousarray(desc_cur, np.uint32)
    desc_prev = np.ascontiguousarray(desc_prev, np.uint32)
    pts_cur = np.ascontiguousarray(pts_cur, np.float32)
    pts_prev = np.ascontiguousarray(pts_prev, np.float32)
    out = np.empty(len(desc_cur), np.int64)
    lib.match_tracker(desc_cur, pts_cur, len(desc_cur),
                      desc_prev, pts_prev, len(desc_prev),
                      float(max_motion), np.int32(thr), float(lowe), out)
    return out


def pack_camera(camera) -> np.ndarray:
    """Pack a geometry/camera.py model into the 12-double layout the native
    ``triangulate_pairs`` reprojection gate consumes. None for unsupported
    camera classes (callers fall back to the NumPy path)."""
    from slam_tpu_torch.geometry.camera import KannalaBrandtCamera, PinholeCamera
    if isinstance(camera, PinholeCamera):
        kind, d = 0.0, (camera.k1, camera.k2, camera.p1, camera.p2)
    elif isinstance(camera, KannalaBrandtCamera):
        kind, d = 1.0, (camera.k1, camera.k2, camera.k3, camera.k4)
    else:
        return None
    return np.asarray([kind, camera.fx, camera.fy, camera.cx, camera.cy,
                       *d, camera.width, camera.height,
                       float(camera.get_focal_length())], np.float64)


def triangulate_pairs(kp_cur, kp_adj, cur_frame, adj_frame,
                      cos_min: float, sigma2_rel, rel_thr: float,
                      chi2: float):
    """Fused two-view triangulation + acceptance gates for matched fresh
    pairs (NumPy twin: pipeline/mapper_helpers._batch_triangulate_pairs).

    ``cur_frame``/``adj_frame``: (pose_cw 3x4 f64, bearings (n,3) f64,
    depth (n,) f32, npix (n,2) f64, nok (n,) u8, pts (n,2) f32,
    octave (n,) i32, cam_pack (12,) f64) per keyframe.
    Returns (positions (B,3) f64, ok (B,) bool), or None when the native
    library or the camera model is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    for frame in (cur_frame, adj_frame):
        if frame[-1] is None:
            return None
    kp_cur = np.ascontiguousarray(kp_cur, np.int64)
    kp_adj = np.ascontiguousarray(kp_adj, np.int64)
    B = len(kp_cur)
    pos = np.empty((B, 3), np.float64)
    ok = np.empty(B, np.uint8)
    args = []
    for frame in (cur_frame, adj_frame):
        pose, bear, depth, npix, nok, pts, octv, cam = frame
        args += [np.ascontiguousarray(pose, np.float64),
                 np.ascontiguousarray(bear, np.float64),
                 np.ascontiguousarray(depth, np.float32),
                 np.ascontiguousarray(npix, np.float64),
                 np.ascontiguousarray(nok, np.uint8),
                 np.ascontiguousarray(pts, np.float32),
                 np.ascontiguousarray(octv, np.int32),
                 np.ascontiguousarray(cam, np.float64)]
    lib.triangulate_pairs(kp_cur, kp_adj, B, *args,
                          float(cos_min),
                          np.ascontiguousarray(sigma2_rel, np.float64),
                          float(rel_thr), float(chi2), pos, ok)
    return pos, ok.astype(bool)


def match_triangulate_pair(cur_match, adj_match, pose1, pose2,
                           scale_factors, epi_thr_deg: float, thr_low: int,
                           cur_frame, adj_frame,
                           cos_min: float, sigma2_rel, rel_thr: float,
                           chi2: float):
    """Fused createNewMapPoints pair stage: epipolar-gated greedy matching +
    rotation-consistency vote + gated two-view triangulation in one native
    call (NumPy twin: matcher.match_for_triangulation followed by
    triangulate_pairs / _batch_triangulate_pairs).

    ``cur_match``/``adj_match``: (descriptors (n,8) u32, groups (n,) i32,
    free (n,) u8, bearings (n,3) f64, angles (n,) f32[, octave (n,) i32 —
    current side only]); ``cur_frame``/``adj_frame``: the triangulation
    blocks of :func:`triangulate_pairs`. Returns (kp_cur, kp_adj,
    positions (B,3) f64, ok (B,) bool) or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if cur_frame[-1] is None or adj_frame[-1] is None:
        return None
    desc1, groups1, free1, bear1, ang1, oct1 = cur_match
    desc2, groups2, free2, bear2, ang2 = adj_match
    n1, n2 = len(desc1), len(desc2)
    kp_cur = np.empty(max(n1, 1), np.int64)
    kp_adj = np.empty(max(n1, 1), np.int64)
    pos = np.zeros((max(n1, 1), 3), np.float64)
    ok = np.zeros(max(n1, 1), np.uint8)
    if n1 == 0 or n2 == 0:
        return kp_cur[:0], kp_adj[:0], pos[:0], ok[:0].astype(bool)

    def c64(a):
        return np.ascontiguousarray(a, np.float64)

    B = lib.match_triangulate_pair(
        np.ascontiguousarray(desc1, np.uint32),
        np.ascontiguousarray(groups1, np.int32),
        np.ascontiguousarray(free1, np.uint8), c64(bear1),
        np.ascontiguousarray(ang1, np.float32),
        np.ascontiguousarray(oct1, np.int32), n1,
        np.ascontiguousarray(desc2, np.uint32),
        np.ascontiguousarray(groups2, np.int32),
        np.ascontiguousarray(free2, np.uint8), c64(bear2),
        np.ascontiguousarray(ang2, np.float32), n2,
        c64(pose1), c64(pose2), c64(scale_factors), len(scale_factors),
        float(epi_thr_deg), np.int32(thr_low),
        np.ascontiguousarray(cur_frame[2], np.float32), c64(cur_frame[3]),
        np.ascontiguousarray(cur_frame[4], np.uint8),
        np.ascontiguousarray(cur_frame[5], np.float32), c64(cur_frame[7]),
        np.ascontiguousarray(adj_frame[2], np.float32), c64(adj_frame[3]),
        np.ascontiguousarray(adj_frame[4], np.uint8),
        np.ascontiguousarray(adj_frame[5], np.float32),
        np.ascontiguousarray(adj_frame[6], np.int32), c64(adj_frame[7]),
        float(cos_min), c64(sigma2_rel), float(rel_thr), float(chi2),
        kp_cur, kp_adj, pos, ok)
    return kp_cur[:B], kp_adj[:B], pos[:B], ok[:B].astype(bool)


def create_random_array(n: int, lo: int, hi: int,
                        seed: Optional[int] = None) -> np.ndarray:
    """n unique random ints in [lo, hi] from a deterministic MT19937 stream
    (reference: openvslam/random_array.cc:21-62, seed 94235682)."""
    lib = get_lib()
    if lib is not None:
        if seed is not None:
            lib.seed_random(np.uint32(seed))
        out = np.empty(n, np.int32)
        lib.create_random_array(n, np.int32(lo), np.int32(hi), out)
        return out
    rng = np.random.default_rng(94235682 if seed is None else seed)
    return rng.choice(np.arange(lo, hi + 1), size=n, replace=False).astype(np.int32)
