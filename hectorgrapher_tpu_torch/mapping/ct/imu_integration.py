"""IMU integration / preintegration between control points.

(ref: cartographer/mapping/internal/3d/imu_integration.h — IntegrateIMU
produces IntegrateImuWithTranslationResult{delta_translation,
delta_velocity, delta_rotation} by zero-order-hold integration over the
IMU samples bracketing [t0, t1]; RK4 variant behind WITH_RK4; linear
acceleration / angular velocity calibration matrices applied per sample.)

Host-side numpy: runs once per control-point pair per window (tiny), so
the streaming path stays off-device. The window solver consumes only the
preintegrated deltas. A copy of hectorgrapher_tpu/mapping/ct/imu_integration.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from hectorgrapher_tpu_torch.transform import np_quat as nq


def _segments(times: np.ndarray, t0: float, t1: float):
    """Yield (dt, sample_index) pairs covering [t0, t1] with zero-order hold.

    Sample i is held on [times[i], times[i+1]); the sample active at t0 is
    the last one with time <= t0 (or the first sample).
    """
    assert t1 >= t0
    if len(times) == 0:
        return
    i = int(np.searchsorted(times, t0, side="right")) - 1
    i = max(i, 0)
    t = t0
    while t < t1:
        t_next = times[i + 1] if i + 1 < len(times) else np.inf
        seg_end = min(t_next, t1)
        yield seg_end - t, i
        t = seg_end
        i = min(i + 1, len(times) - 1)
        if t >= t1:
            break


def integrate_gyro(
    times: np.ndarray,
    angular_velocities: np.ndarray,
    t0: float,
    t1: float,
    calibration: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Gyro-only delta rotation quaternion over [t0, t1] (wxyz)."""
    q = nq.quat_identity()
    for dt, i in _segments(times, t0, t1):
        w = angular_velocities[i]
        if calibration is not None:
            w = calibration @ w
        q = nq.quat_multiply(q, nq.quat_from_axis_angle(w * dt))
    return nq.quat_normalize(q)


def integrate_imu(
    times: np.ndarray,
    linear_accelerations: np.ndarray,
    angular_velocities: np.ndarray,
    t0: float,
    t1: float,
    acc_calibration: Optional[np.ndarray] = None,
    gyro_calibration: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full body-frame preintegration (no gravity subtraction).

    Returns (delta_rotation wxyz, delta_velocity, delta_translation) in the
    start-time body frame (ref: imu_integration.h IntegrateIMU).
    """
    q = nq.quat_identity()
    dv = np.zeros(3)
    dp = np.zeros(3)
    for dt, i in _segments(times, t0, t1):
        a = linear_accelerations[i]
        w = angular_velocities[i]
        if acc_calibration is not None:
            a = acc_calibration @ a
        if gyro_calibration is not None:
            w = gyro_calibration @ w
        a_world = nq.quat_rotate(q, a)
        dp = dp + dv * dt + 0.5 * a_world * dt * dt
        dv = dv + a_world * dt
        q = nq.quat_multiply(q, nq.quat_from_axis_angle(w * dt))
    return nq.quat_normalize(q), dv, dp


def _gyro_at(times: np.ndarray, gyros: np.ndarray, t: float) -> np.ndarray:
    """Linearly-interpolated angular velocity at t (clamped)."""
    i = int(np.searchsorted(times, t))
    if i <= 0:
        return gyros[0]
    if i >= len(times):
        return gyros[-1]
    f = (t - times[i - 1]) / max(times[i] - times[i - 1], 1e-12)
    return gyros[i - 1] + f * (gyros[i] - gyros[i - 1])


def integrate_gyro_rk4(
    times: np.ndarray,
    angular_velocities: np.ndarray,
    t0: float,
    t1: float,
    calibration: Optional[np.ndarray] = None,
    max_step: float = 0.01,
) -> np.ndarray:
    """RK4 delta rotation over [t0, t1] with linearly-interpolated gyro
    (ref: imu_integration.h RK4 path behind WITH_RK4 :25,185 — the
    reference default imu_integrator = "RK4",
    trajectory_builder_3d.lua:133)."""
    if calibration is not None:
        angular_velocities = angular_velocities @ calibration.T
    q = nq.quat_identity()
    n_steps = max(1, int(np.ceil((t1 - t0) / max_step)))
    h = (t1 - t0) / n_steps
    t = t0
    for _ in range(n_steps):
        w1 = _gyro_at(times, angular_velocities, t)
        w2 = _gyro_at(times, angular_velocities, t + 0.5 * h)
        w4 = _gyro_at(times, angular_velocities, t + h)

        def qdot(qq, w):
            # dq/dt = 0.5 * q * [0, w]
            return 0.5 * nq.quat_multiply(qq, np.array([0.0, w[0], w[1], w[2]]))

        k1 = qdot(q, w1)
        k2 = qdot(q + 0.5 * h * k1, w2)
        k3 = qdot(q + 0.5 * h * k2, w2)
        k4 = qdot(q + h * k3, w4)
        q = nq.quat_normalize(q + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4))
        t += h
    return q


def calibrate_imu_static(
    times: np.ndarray,
    linear_accelerations: np.ndarray,
    gravity_magnitude: float = 9.80665,
) -> Tuple[float, np.ndarray]:
    """Static IMU calibration: gravity constant + accel scale matrix.

    (ref: internal/3d/imu_static_calibration.h CalibrateIMU — assumes the
    robot is static during initialization; the scale correction rescales
    the mean acceleration magnitude to the given gravity constant, which
    stays the authoritative gravity for integration. Returning the RAW
    norm as the gravity constant while also rescaling would leave a
    constant vertical acceleration bias in every window solve.)
    Returns (gravity_constant, 3x3 linear_acceleration_calibration).
    """
    if len(linear_accelerations) == 0:
        return gravity_magnitude, np.eye(3)
    mean_acc = np.mean(linear_accelerations, axis=0)
    norm = float(np.linalg.norm(mean_acc))
    if norm < 1e-6:
        return gravity_magnitude, np.eye(3)
    scale = gravity_magnitude / norm
    return gravity_magnitude, np.eye(3) * scale


def direct_imu_samples(
    times: np.ndarray,
    accelerations: np.ndarray,
    angular_velocities: np.ndarray,
    t0: float,
    t1: float,
    max_samples: int,
    acc_calibration: Optional[np.ndarray] = None,
    gyro_calibration: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static-shape sample buffers for the DIRECT IMU cost term.

    (ref: prediction_direct_imu_integration_cost_functor.h — the functor
    walks the raw sample list inside the residual. Here the walk happens
    on device over fixed-length buffers: exact ZOH segments when they fit
    in `max_samples`, uniform ZOH resampling otherwise. Unused slots have
    dt == 0 and integrate to a no-op.)

    Returns (dt (M,), gyro (M,3), accel (M,3)) float32, calibrated.
    """
    m = max_samples
    dts = np.zeros(m, np.float32)
    gy = np.zeros((m, 3), np.float32)
    ac = np.zeros((m, 3), np.float32)
    times = np.asarray(times)
    if len(times) == 0 or t1 <= t0:
        return dts, gy, ac

    def calibrated(i):
        a = np.asarray(accelerations[i], np.float64)
        w = np.asarray(angular_velocities[i], np.float64)
        if acc_calibration is not None:
            a = acc_calibration @ a
        if gyro_calibration is not None:
            w = gyro_calibration @ w
        return a, w

    segs = list(_segments(times, t0, t1))
    if len(segs) <= m:
        for j, (dt, i) in enumerate(segs):
            a, w = calibrated(i)
            dts[j] = dt
            ac[j] = a
            gy[j] = w
    else:
        step = (t1 - t0) / m
        for j in range(m):
            ts = t0 + j * step
            i = max(int(np.searchsorted(times, ts, side="right")) - 1, 0)
            a, w = calibrated(i)
            dts[j] = step
            ac[j] = a
            gy[j] = w
    return dts, gy, ac
