"""Parity of the torch port's geometry ops with the JAX package on CPU:
Lie-group maps (float32 and float64), camera projection/unprojection for
both camera kinds, and two-view triangulation. Inputs come from numpy seeds
and pass to both packages as numpy arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.geometry import camera as jgeo
from slam_tpu.ops import camera_jax as jcam
from slam_tpu.ops import lie as jlie
from slam_tpu.ops.ransac import triangulate_two_view_jax
from slam_tpu_torch.geometry import camera as tgeo
from slam_tpu_torch.ops import camera as tcam
from slam_tpu_torch.ops import lie as tlie
from slam_tpu_torch.ops.ransac import triangulate_two_view

torch.set_num_threads(1)

# float32: a few ulps of the O(1) outputs after a handful of transcendental
# ops evaluated by two libraries; float64: the same chain at double ulps
TOL = {np.float32: 2e-6, np.float64: 1e-12}


def _tangents(rng, n, dtype):
    xi = rng.normal(0, 0.5, (n, 6))
    xi[: n // 4, :3] *= 1e-7        # exercise the small-angle branches
    xi[n // 4: n // 2, :3] = 0.0
    return xi.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lie_matches_jax(dtype):
    rng = np.random.default_rng(0)
    xi = _tangents(rng, 64, dtype)
    with jax.enable_x64(dtype == np.float64):
        j_T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        j_log = np.asarray(jlie.se3_log(jnp.asarray(j_T)))
        j_inv = np.asarray(jlie.se3_inverse(jnp.asarray(j_T)))
        j_R = np.asarray(jlie.so3_exp(jnp.asarray(xi[:, :3])))
        j_w = np.asarray(jlie.so3_log(jnp.asarray(j_R)))
        j_K = np.asarray(jlie.skew(jnp.asarray(xi[:, 3:])))
    assert j_T.dtype == dtype
    t = torch.from_numpy
    tol = TOL[dtype]
    np.testing.assert_allclose(tlie.se3_exp(t(xi)).numpy(), j_T, atol=tol)
    np.testing.assert_allclose(tlie.se3_log(t(j_T)).numpy(), j_log, atol=tol * 4)
    np.testing.assert_allclose(tlie.se3_inverse(t(j_T)).numpy(), j_inv,
                               atol=tol)
    np.testing.assert_allclose(tlie.so3_exp(t(xi[:, :3])).numpy(), j_R, atol=tol)
    np.testing.assert_allclose(tlie.so3_log(t(j_R)).numpy(), j_w, atol=tol * 4)
    np.testing.assert_array_equal(tlie.skew(t(xi[:, 3:])).numpy(), j_K)


def test_batched_jacfwd_matches_jax_jacfwd():
    """The port's forward-mode Jacobian of the SE3 prior error (written out
    in ``ops/lie``, once a batched jvp) agrees with jax.jacfwd at the
    identity tangent (the BA prior linearisation)."""
    rng = np.random.default_rng(1)
    Ta = np.asarray(jlie.se3_exp(jnp.asarray(_tangents(rng, 8, np.float32))))
    C = np.asarray(jlie.se3_exp(jnp.asarray(_tangents(rng, 8, np.float32))))

    def err_j(xi, T, C):
        return jlie.se3_log(jlie.se3_inverse(jlie.se3_exp(xi) @ T) @ C)

    want = np.stack([np.asarray(jax.jacfwd(err_j)(jnp.zeros(6), T, c))
                     for T, c in zip(Ta, C)])
    e, got = tlie.prior_error_and_jacobian(torch.from_numpy(Ta),
                                           torch.from_numpy(C))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(
        e.numpy(), np.stack([np.asarray(err_j(jnp.zeros(6), T, c))
                             for T, c in zip(Ta, C)]), atol=2e-5)


@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.3], ids=["exact", "small",
                                                          "large"])
def test_edge_jacobians_match_jax_jacfwd(scale):
    """Both vertices' Jacobians of the EdgeSE3Expmap error against
    jax.jacfwd of the JAX package's ``ba._pe_error_fn``, for measurements
    that explain the poses exactly, nearly and loosely (exp's derivative at
    the identity, log's small-angle branch and its arccos branch)."""
    from slam_tpu.ops import ba as jba

    rng = np.random.default_rng(2)
    Ta = np.asarray(jlie.se3_exp(jnp.asarray(_tangents(rng, 8, np.float32))))
    Tb = np.asarray(jlie.se3_exp(jnp.asarray(_tangents(rng, 8, np.float32))))
    noise = np.asarray(jlie.se3_exp(jnp.asarray(
        (rng.normal(0, 1, (8, 6)) * scale).astype(np.float32))))
    C = (noise @ Tb @ np.linalg.inv(Ta)).astype(np.float32)
    z = jnp.zeros(6)
    want_a = np.stack([np.asarray(jax.jacfwd(
        lambda x: jba._pe_error_fn(x, z, a, b, c))(z))
        for a, b, c in zip(Ta, Tb, C)])
    want_b = np.stack([np.asarray(jax.jacfwd(
        lambda x: jba._pe_error_fn(z, x, a, b, c))(z))
        for a, b, c in zip(Ta, Tb, C)])
    e, Ja, Jb = tlie.edge_error_and_jacobians(
        *(torch.from_numpy(x) for x in (Ta, Tb, C)))
    np.testing.assert_allclose(Ja.numpy(), want_a, atol=2e-5)
    np.testing.assert_allclose(Jb.numpy(), want_b, atol=2e-5)
    np.testing.assert_allclose(
        e.numpy(), np.stack([np.asarray(jba._pe_error_fn(z, z, a, b, c))
                             for a, b, c in zip(Ta, Tb, C)]), atol=2e-5)


def _cameras():
    """(class name, fields): each package builds its own camera from them."""
    return [("PinholeCamera", dict(fx=420.0, fy=410.0, cx=322.0, cy=241.0,
                                   width=640, height=480, k1=-0.05, k2=0.01,
                                   p1=1e-3, p2=-5e-4)),
            ("KannalaBrandtCamera", dict(fx=300.0, fy=300.0, cx=320.0,
                                         cy=240.0, width=640, height=480,
                                         k1=0.01, k2=-0.005, k3=1e-3,
                                         k4=-1e-4))]


@pytest.mark.parametrize("cam", _cameras(), ids=["pinhole", "kannala_brandt"])
def test_camera_matches_jax(cam):
    rng = np.random.default_rng(2)
    pts = rng.uniform([-3, -3, -1], [3, 3, 8], (256, 3)).astype(np.float32)
    pix = rng.uniform([0, 0], [640, 480], (256, 2)).astype(np.float32)
    cls, fields = cam
    kind, params = jcam.pack_camera(getattr(jgeo, cls)(**fields))
    kind_t, params_t = tcam.pack_camera(getattr(tgeo, cls)(**fields))
    assert kind == kind_t
    np.testing.assert_array_equal(params, params_t)
    j_uv, j_ok = (np.asarray(a) for a in jcam.project(kind, jnp.asarray(params),
                                                      jnp.asarray(pts)))
    t_uv, t_ok = tcam.project(kind, torch.from_numpy(params),
                              torch.from_numpy(pts))
    np.testing.assert_array_equal(t_ok.numpy(), j_ok)
    # pixels: f32 rounding of |uv| ~ 1e3 after the distortion polynomial
    np.testing.assert_allclose(t_uv.numpy()[j_ok], j_uv[j_ok], rtol=1e-5,
                               atol=1e-3)
    j_b = np.asarray(jcam.unproject(kind, jnp.asarray(params),
                                    jnp.asarray(pix)))
    t_b = tcam.unproject(kind, torch.from_numpy(params), torch.from_numpy(pix))
    # unit bearings after five fixed-point / Newton iterations in f32
    np.testing.assert_allclose(t_b.numpy(), j_b, atol=2e-6)


def test_triangulate_two_view_matches_jax():
    rng = np.random.default_rng(3)
    T21 = np.asarray(jlie.se3_exp(jnp.asarray(
        np.array([0.02, -0.05, 0.01, 0.3, 0.02, -0.05], np.float32))))
    X1 = rng.uniform([-2, -2, 2], [2, 2, 8], (200, 3)).astype(np.float32)
    X2 = X1 @ T21[:3, :3].T + T21[:3, 3]
    b1 = (X1 / np.linalg.norm(X1, axis=1, keepdims=True)
          + rng.normal(0, 1e-3, X1.shape)).astype(np.float32)
    b2 = (X2 / np.linalg.norm(X2, axis=1, keepdims=True)
          + rng.normal(0, 1e-3, X2.shape)).astype(np.float32)
    b2[:10] = b1[:10] @ T21[:3, :3].T   # parallel rays: masked out
    j_pts, j_ok = (np.asarray(a) for a in triangulate_two_view_jax(
        jnp.asarray(T21[:3, :3]), jnp.asarray(T21[:3, 3]), jnp.asarray(b1),
        jnp.asarray(b2)))
    t_pts, t_ok = triangulate_two_view(
        torch.from_numpy(T21[:3, :3]), torch.from_numpy(T21[:3, 3]),
        torch.from_numpy(b1), torch.from_numpy(b2))
    np.testing.assert_array_equal(t_ok.numpy(), j_ok)
    assert j_ok.sum() > 150
    # 3x3 damped solves of f32 systems: relative 1e-4 of the point depth
    np.testing.assert_allclose(t_pts.numpy()[j_ok], j_pts[j_ok], rtol=1e-4,
                               atol=1e-4)
