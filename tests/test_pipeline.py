"""End-to-end incremental SfM session (pipeline.SfmSession).

VERDICT r3 item 4's acceptance test: reconstruct a 20-frame synthetic
sequence FROM SCRATCH — only 2-D tracks are fed in, no GT poses or points
— and reach the injected-noise floor after the final bundle adjustment.
The observations come from the synthetic config generators, so the oracle
is the same noise-floor envelope the golden solver tests use.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from rsba_tpu.pipeline import SfmSession
from rsba_tpu.problem import synthetic


def _frames_from(ba):
    """Split a SyntheticBA's observations into per-frame track lists."""
    obs = ba.problem.obs
    m = np.asarray(obs.mask) > 0
    pa = np.asarray(obs.pose_a)[m]
    pid = np.asarray(obs.point)[m]
    uv = np.asarray(obs.uv)[m]
    frames = []
    for f in range(int(pa.max()) + 1):
        sel = pa == f
        frames.append((pid[sel], uv[sel]))
    return frames


@pytest.mark.slow  # 305 s: the 20-frame f64 GS variant.  The identical
# GS path (bootstrap → register → triangulate → windowed BA) runs in the
# fast suite via test_session_f32_mode, which also checks poses vs GT.
def test_session_reconstructs_gs_sequence_from_scratch():
    ba = synthetic.make_ba_problem(
        n_poses=20, n_points=400, track_len=6, rolling_shutter=False,
        use_distortion=False, pixel_noise=0.5, seed=2, name="session_gs")
    intr = np.asarray(ba.params_gt.intr[0])
    sess = SfmSession(intr, ba.problem.model, ba.image_size,
                      window=8, ba_interval=5)
    for pid, uv in _frames_from(ba):
        sess.add_frame(pid, uv)
    assert sess.bootstrapped
    assert all(sess.registered), [r for r in sess.log
                                  if not r.get("registered", True)]
    # ≥60% of tracks triangulated (short tracks at sequence edges may not
    # accumulate enough parallax).
    assert len(sess.points) >= 0.6 * 400
    s = sess.bundle_adjust(window=None)
    assert s.termination == "CONVERGENCE", s.message
    assert s.final_rmse_inlier < 1.7 * ba.pixel_noise, s.final_rmse_inlier

    # Poses match GT up to the similarity gauge: the similarity conjugates
    # relative rotations, so their rotation ANGLE is the invariant.
    from rsba_tpu.geometry import quaternion as quat
    q_est, c_est, _ = sess.reconstruction()
    q_gt = np.asarray(ba.params_gt.q)
    rel_est = quat.relative(jnp.asarray(q_est[:-1]), jnp.asarray(q_est[1:]))
    rel_gt = quat.relative(jnp.asarray(q_gt[:-1]), jnp.asarray(q_gt[1:]))
    ang_est = np.linalg.norm(np.asarray(quat.to_axis_angle(rel_est)), axis=-1)
    ang_gt = np.linalg.norm(np.asarray(quat.to_axis_angle(rel_gt)), axis=-1)
    np.testing.assert_allclose(ang_est, ang_gt, atol=2e-3)


def test_session_reconstructs_rs_sequence_from_scratch():
    ba = synthetic.make_ba_problem(
        n_poses=13, n_points=300, track_len=6, rolling_shutter=True,
        rotation_interp="nlerp", use_distortion=False, pixel_noise=0.5,
        seed=4, name="session_rs")
    obs = ba.problem.obs
    m = np.asarray(obs.mask) > 0
    pa = np.asarray(obs.pose_a)[m]
    pid = np.asarray(obs.point)[m]
    uv = np.asarray(obs.uv)[m]
    H = ba.image_size[1]
    intr = np.asarray(ba.params_gt.intr[0])
    sess = SfmSession(intr, ba.problem.model, ba.image_size,
                      window=6, ba_interval=4)
    for f in range(int(pa.max()) + 1):
        sel = pa == f
        sess.add_frame(pid[sel], uv[sel], rows=uv[sel, 1])
    assert sess.bootstrapped
    assert all(sess.registered)
    s = sess.bundle_adjust(window=None)
    assert s.termination == "CONVERGENCE", s.message
    # The session's shutter times come from measured (noisy) rows rather
    # than the generator's fixed-point rows — a slightly different
    # measurement model, so allow a wider envelope than the golden tests.
    assert s.final_rmse_inlier < 2.5 * ba.pixel_noise, s.final_rmse_inlier


def test_session_defers_bootstrap_without_parallax():
    # Two identical frames: no baseline → two-view init must not fire.
    rng = np.random.RandomState(0)
    pid = np.arange(50)
    uv = rng.uniform(100, 500, (50, 2))
    from rsba_tpu.geometry import CameraModel
    intr = np.array([800.0, 800, 320, 240, 0, 0, 0, 0, 0])
    sess = SfmSession(intr, CameraModel(), (640, 480))
    sess.add_frame(pid, uv)
    r = sess.add_frame(pid, uv + rng.randn(50, 2) * 0.05)
    assert not sess.bootstrapped
    assert r["event"] == "bootstrap_deferred"


def test_session_f32_mode():
    """f32 session — the accelerator dtype: bootstrap, registration,
    triangulation and BA must all be f32-safe.  The GPU run of this mode
    is chip_smoke.py's session phase."""
    ba = synthetic.make_ba_problem(
        n_poses=14, n_points=300, track_len=6, rolling_shutter=False,
        use_distortion=False, pixel_noise=0.5, seed=6, name="session_f32")
    intr = np.asarray(ba.params_gt.intr[0])
    sess = SfmSession(intr, ba.problem.model, ba.image_size,
                      window=6, ba_interval=4, dtype=jnp.float32)
    for pid, uv in _frames_from(ba):
        sess.add_frame(pid, uv)
    assert sess.bootstrapped
    assert all(sess.registered), [r for r in sess.log
                                  if not r.get("registered", True)]
    s = sess.bundle_adjust(window=None)
    assert s.final_rmse_inlier < 2.0 * ba.pixel_noise, s.final_rmse_inlier

    # Pose accuracy vs GT (moved here from the slow-marked 20-frame GS
    # test so the fast suite keeps the oracle): the similarity gauge
    # conjugates relative rotations, so their ANGLE is the invariant.
    from rsba_tpu.geometry import quaternion as quat
    q_est, c_est, _ = sess.reconstruction()
    q_gt = np.asarray(ba.params_gt.q)
    rel_est = quat.relative(jnp.asarray(q_est[:-1]), jnp.asarray(q_est[1:]))
    rel_gt = quat.relative(jnp.asarray(q_gt[:-1]), jnp.asarray(q_gt[1:]))
    ang_est = np.linalg.norm(np.asarray(quat.to_axis_angle(rel_est)), axis=-1)
    ang_gt = np.linalg.norm(np.asarray(quat.to_axis_angle(rel_gt)), axis=-1)
    np.testing.assert_allclose(ang_est, ang_gt, atol=3e-3)
