"""SO(3) / quaternion / Euler utilities for the JAX ELiMaLoc rebuild.

Re-implements, with identical semantics, the Lie-algebra and angle helpers of the
reference's shared math header (reference: src/app/localization/localization_interface/
localization_functions.hpp:248-483) as pure, dtype-agnostic ``jax.numpy`` functions.

Design notes:
  * All small-angle branches are expressed with ``jnp.where`` on safe operands
    (no data-dependent Python control flow) so every function is jit/vmap-able.
  * Quaternions are ``[..., 4]`` arrays in ``(w, x, y, z)`` order.
  * Functions follow input dtypes; tests run them in float64 on CPU for parity,
    the device pipeline runs float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST  # GPU f32 matmuls may default to TF32

_EPS_THETA = 1e-5  # small-angle guard, same threshold as the reference


# --------------------------------------------------------------------------- #
# Angle helpers (localization_functions.hpp:248-303)
# --------------------------------------------------------------------------- #

def norm_angle_rad(angle):
    """Wrap angle(s) to (-pi, pi]. Reference: NormAngleRad (hpp:263-271)."""
    angle = jnp.asarray(angle)
    two_pi = 2.0 * jnp.pi
    wrapped = jnp.mod(angle + jnp.pi, two_pi) - jnp.pi
    # jnp.mod already yields [0, 2pi) for any sign, so wrapped is in [-pi, pi).
    # The reference's while-loop yields (-pi, pi]; map -pi -> pi for exactness.
    return jnp.where(wrapped == -jnp.pi, jnp.pi, wrapped)


def norm_angle_deg(angle):
    """Wrap angle(s) to [0, 360). Reference: NormAngleDeg (hpp:248-256)."""
    return jnp.mod(jnp.asarray(angle), 360.0)


def angle_diff_rad(ref, rel):
    """Shortest signed difference rel - ref in radians. Reference: AngleDiffRad."""
    return norm_angle_rad(jnp.asarray(rel) - jnp.asarray(ref))


def angle_diff_deg(ref, rel):
    """Shortest signed difference rel - ref in degrees. Reference: AngleDiffDeg."""
    d = jnp.mod(jnp.asarray(rel) - jnp.asarray(ref) + 180.0, 360.0) - 180.0
    return jnp.where(d == -180.0, 180.0, d)


# --------------------------------------------------------------------------- #
# so(3) <-> SO(3) (localization_functions.hpp:380-483)
# --------------------------------------------------------------------------- #

def skew(v):
    """3-vector(s) -> skew-symmetric matrix. Reference: SkewSymmetricMatrix (hpp:380)."""
    v = jnp.asarray(v)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(omega):
    """so(3) vector -> rotation matrix (Rodrigues). Reference: Exp (hpp:410-419)."""
    omega = jnp.asarray(omega)
    theta = jnp.linalg.norm(omega, axis=-1, keepdims=True)
    small = theta < _EPS_THETA
    safe_theta = jnp.where(small, jnp.ones_like(theta), theta)
    axis = omega / safe_theta
    k = skew(axis)
    t = theta[..., None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), k.shape)
    rot = eye + jnp.sin(t) * k + (1.0 - jnp.cos(t)) * (k @ k)
    return jnp.where(small[..., None], eye, rot)


def so3_log(rot):
    """Rotation matrix -> so(3) vector. Reference: Log (hpp:393-403).

    Uses the same trace/asin formulation with clamping; the small-angle branch
    returns zero exactly as the reference does.
    """
    rot = jnp.asarray(rot)
    cos_theta = (jnp.trace(rot, axis1=-2, axis2=-1) - 1.0) / 2.0
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    small = jnp.abs(theta) < _EPS_THETA
    safe_sin = jnp.where(small, jnp.ones_like(theta), jnp.sin(theta))
    log_m = (rot - jnp.swapaxes(rot, -1, -2)) / (2.0 * safe_sin)[..., None, None]
    vec = jnp.stack(
        [log_m[..., 2, 1], log_m[..., 0, 2], log_m[..., 1, 0]], axis=-1
    )
    return jnp.where(small[..., None], jnp.zeros_like(vec), theta[..., None] * vec)


def exp_gyro_to_rot(gyro, dt):
    """Rotation increment from body rates over dt. Reference: ExpGyroToRotMatrix."""
    return so3_exp(jnp.asarray(gyro) * dt)


def right_jacobian_d_rot_d_gyro(gyro, dt):
    """d Exp(gyro*dt) / d gyro — the scaled right Jacobian.

    Reference: PartialDerivativeRotWrtGyro (hpp:466-483). Returns zero for
    near-zero rotation, matching the reference's early-out.
    """
    gyro = jnp.asarray(gyro)
    omega = gyro * dt
    theta = jnp.linalg.norm(omega, axis=-1, keepdims=True)
    small = theta < _EPS_THETA
    safe_theta = jnp.where(small, jnp.ones_like(theta), theta)
    axis = omega / safe_theta
    k = skew(axis)
    t = safe_theta[..., None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=gyro.dtype), k.shape)
    jac = dt * (
        eye
        + (1.0 - jnp.cos(t)) / (t * t) * k
        + (t - jnp.sin(t)) / (t * t * t) * (k @ k)
    )
    return jnp.where(small[..., None], jnp.zeros_like(jac), jac)


# --------------------------------------------------------------------------- #
# Euler <-> rotation matrix with gimbal-lock branch (hpp:312-345)
# --------------------------------------------------------------------------- #

def rot_to_euler(rot):
    """Rotation matrix -> (roll, pitch, yaw), gimbal-lock-safe.

    Reference: RotToVec (hpp:312-333), including the |R(2,0)| > 0.998 branch and
    the final fmod-style renormalization (which, like the reference, uses the
    C ``fmod`` sign convention).
    """
    rot = jnp.asarray(rot)
    r20 = rot[..., 2, 0]
    locked = jnp.abs(r20) > 0.998

    # Gimbal-locked branch
    yaw_l = jnp.arctan2(-rot[..., 1, 2], rot[..., 1, 1])
    pitch_l = (jnp.pi / 2.0) * jnp.where(r20 >= 0, 1.0, -1.0)
    roll_l = jnp.zeros_like(yaw_l)

    # Regular branch
    pitch = jnp.arcsin(-jnp.clip(r20, -1.0, 1.0))
    cp = jnp.cos(pitch)
    safe_cp = jnp.where(jnp.abs(cp) < 1e-12, jnp.ones_like(cp), cp)
    roll = jnp.arctan2(rot[..., 2, 1] / safe_cp, rot[..., 2, 2] / safe_cp)
    yaw = jnp.arctan2(rot[..., 1, 0] / safe_cp, rot[..., 0, 0] / safe_cp)

    angles = jnp.stack(
        [
            jnp.where(locked, roll_l, roll),
            jnp.where(locked, pitch_l, pitch),
            jnp.where(locked, yaw_l, yaw),
        ],
        axis=-1,
    )
    # Reference applies fmod(a + pi, 2 pi) - pi (C fmod keeps dividend sign).
    return jnp.fmod(angles + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def euler_to_rot(rpy):
    """(roll, pitch, yaw) -> rotation matrix, Rz(yaw) Ry(pitch) Rx(roll).

    Reference: VecToRot (hpp:340-345).
    """
    rpy = jnp.asarray(rpy)
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    row0 = jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = jnp.stack([-sp, cp * sr, cp * cr], -1)
    return jnp.stack([row0, row1, row2], axis=-2)


# --------------------------------------------------------------------------- #
# Quaternions, (w, x, y, z)
# --------------------------------------------------------------------------- #

def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q):
    q = jnp.asarray(q)
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    safe = jnp.where(n < 1e-30, jnp.ones_like(n), n)
    return q / safe


def quat_mul(a, b):
    """Hamilton product a ⊗ b (both (w,x,y,z))."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_to_rot(q):
    """Unit quaternion -> rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1
    )
    row1 = jnp.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1
    )
    row2 = jnp.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1
    )
    return jnp.stack([row0, row1, row2], axis=-2)


def rot_to_quat(rot):
    """Rotation matrix -> unit quaternion (w >= 0 convention), branch-free.

    Uses the max-trace/diagonal 4-way selection expressed with jnp.where so it
    is jit-safe and numerically stable for all rotations.
    """
    rot = jnp.asarray(rot)
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick the one with the largest pivot.
    def build(pw, px, py, pz):
        return jnp.stack([pw, px, py, pz], axis=-1)

    s0 = jnp.sqrt(jnp.maximum(1.0 + tr, 1e-30)) * 2.0  # 4w
    q0 = build(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0)
    s1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-30)) * 2.0  # 4x
    q1 = build((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1)
    s2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-30)) * 2.0  # 4y
    q2 = build((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2)
    s3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-30)) * 2.0  # 4z
    q3 = build((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = jnp.where(
        cond0[..., None],
        q0,
        jnp.where(cond1[..., None], q1, jnp.where(cond2[..., None], q2, q3)),
    )
    q = quat_normalize(q)
    return jnp.where(q[..., 0:1] < 0, -q, q)


def quat_from_axis_angle(axis_vec):
    """Rotation-vector -> quaternion with the safe-normalization guard.

    Matches the reference's AngleAxisd(norm(v), v.normalized()) idiom used in
    UpdateEkfState (ekf_algorithm.hpp:133-141), returning identity for ~zero v.
    """
    v = jnp.asarray(axis_vec)
    angle = jnp.linalg.norm(v, axis=-1, keepdims=True)
    small = angle < 1e-12
    safe = jnp.where(small, jnp.ones_like(angle), angle)
    axis = v / safe
    half = 0.5 * angle[..., 0]
    q = jnp.concatenate(
        [jnp.cos(half)[..., None], jnp.sin(half)[..., None] * axis], axis=-1
    )
    ident = jnp.zeros_like(q).at[..., 0].set(1.0)
    return jnp.where(small, ident, q)


def exp_gyro_to_quat(gyro, dt):
    """Quaternion increment from body rates over dt. Reference: ExpGyroToQuat."""
    return rot_to_quat(so3_exp(jnp.asarray(gyro) * dt))


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q."""
    return jnp.einsum("...ij,...j->...i", quat_to_rot(q), jnp.asarray(v),
                      precision=_HI)


def euler_residual_from_quats(state_q, meas_q):
    """Per-axis wrapped Euler residual between two quaternions.

    Reference: CalEulerResidualFromQuat (hpp:355-370) — converts both to Euler
    via the gimbal-safe rot_to_euler and wraps each component.
    """
    s = rot_to_euler(quat_to_rot(state_q))
    m = rot_to_euler(quat_to_rot(meas_q))
    return norm_angle_rad(m - s)


# --------------------------------------------------------------------------- #
# SE(3) 4x4 helpers used by registration / deskew
# --------------------------------------------------------------------------- #

def make_transform(rot, trans):
    """(3x3, 3) -> 4x4 homogeneous transform."""
    rot = jnp.asarray(rot)
    trans = jnp.asarray(trans)
    batch = jnp.broadcast_shapes(rot.shape[:-2], trans.shape[:-1])
    top = jnp.concatenate(
        [
            jnp.broadcast_to(rot, batch + (3, 3)),
            jnp.broadcast_to(trans[..., None], batch + (3, 1)),
        ],
        axis=-1,
    )
    bottom = jnp.zeros(batch + (1, 4), dtype=top.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def compose(a, b):
    """Rigid 4x4 compose a @ b at full f32 precision.

    Pose translations at map scale (~100 m) quantize to ~0.06 m under TF32,
    which a GPU may use for f32 matmuls at default precision — enough to
    freeze ICP (a centimeter step rounds back to the same pose). Every pose
    compose must go through here (or carry an explicit precision=HIGHEST)."""
    return jnp.matmul(a, b, precision=_HI)


def transform_inverse(tf):
    """Closed-form inverse of a rigid 4x4 transform."""
    rot = tf[..., :3, :3]
    trans = tf[..., :3, 3]
    rot_t = jnp.swapaxes(rot, -1, -2)
    return make_transform(
        rot_t, -jnp.einsum("...ij,...j->...i", rot_t, trans, precision=_HI)
    )


def transform_points(tf, pts):
    """Apply 4x4 transform(s) to [..., N, 3] points."""
    rot = tf[..., :3, :3]
    trans = tf[..., :3, 3]
    return (
        jnp.einsum("...ij,...nj->...ni", rot, pts, precision=_HI)
        + trans[..., None, :]
    )


def interpolate_tf_with_time(tf_between, dt_scan, dt_trans):
    """Fractional rigid transform: ratio * translation, slerp(identity, R).

    Reference: InterpolateTfWithTime (hpp:219-241). Returns identity when
    dt_trans == 0.
    """
    ratio = jnp.where(dt_trans == 0.0, 0.0, dt_scan / jnp.where(dt_trans == 0.0, 1.0, dt_trans))
    trans = tf_between[..., :3, 3] * ratio
    rotvec = so3_log(tf_between[..., :3, :3])
    rot = so3_exp(rotvec * ratio)
    ident = jnp.broadcast_to(jnp.eye(4, dtype=tf_between.dtype), tf_between.shape)
    out = make_transform(rot, trans)
    return jnp.where(jnp.asarray(dt_trans == 0.0)[..., None, None], ident, out)


def inv3x3(m):
    """Batched closed-form 3x3 inverse (adjugate/det) — elementwise and
    fusable, where linalg.inv/solve on [...,3,3] stacks would be a batched
    LU library call."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), (b * f - c * e)], axis=-1),
            jnp.stack([B, (a * i - c * g), -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), (a * e - b * d)], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]
