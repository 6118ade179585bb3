"""Camera construction and derivation (Falcor Graphics/Camera semantics).

Reproduces Camera::calculateCameraParameters (Camera.cpp:64-140):
  fovY    = 2*atan(frameHeight/2 / focalLength)
  cameraW = normalize(target - pos) * focalDistance
  cameraU = normalize(cross(W, up)) * focalDistance * tan(fovY/2) * aspect
  cameraV = normalize(cross(U, W)) * focalDistance * tan(fovY/2)
  viewProj = jitterMat * perspective(fovY, aspect, near, far) * lookAt(...)
prevViewProj is the *unjittered* previous-frame matrix (used by BMFR
reprojection, preprocess.ps.hlsl:64).

Matrices use column-vector convention: clip = M @ [p, 1].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vecmath import cross, normalize
from .types import CameraData


def _mm(a, b):
    """4x4 matmul at full f32 precision (a reduced-precision default such as
    TF32 visibly corrupts reprojection matrices)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def look_at(eye, target, up):
    """Right-handed view matrix (glm::lookAt)."""
    f = normalize(target - eye)
    s = normalize(cross(f, up))
    u = cross(s, f)
    m = jnp.stack(
        [
            jnp.concatenate([s, -jnp.stack([_dot(s, eye)])]),
            jnp.concatenate([u, -jnp.stack([_dot(u, eye)])]),
            jnp.concatenate([-f, jnp.stack([_dot(f, eye)])]),
            jnp.asarray([0.0, 0.0, 0.0, 1.0]),
        ]
    )
    return m


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def perspective(fov_y, aspect, near, far):
    """Right-handed, zero-to-one depth (glm perspectiveRH_ZO, Falcor's mode)."""
    t = 1.0 / jnp.tan(fov_y * 0.5)
    z = far / (near - far)
    zero = jnp.zeros(())
    one = jnp.ones(())
    return jnp.stack(
        [
            jnp.stack([t / aspect, zero, zero, zero]),
            jnp.stack([zero, t, zero, zero]),
            jnp.stack([zero, zero, z, z * near]),
            jnp.stack([zero, zero, -one, zero]),
        ]
    )


def focal_length_to_fov_y(focal_length, frame_height):
    return 2.0 * jnp.arctan(0.5 * frame_height / focal_length)


def make_camera(
    pos,
    target,
    up=(0.0, 1.0, 0.0),
    focal_length: float = 21.0,
    frame_height: float = 24.0,
    aspect: float = 16.0 / 9.0,
    near_z: float = 0.1,
    far_z: float = 1000.0,
    focal_distance: float = 10000.0,
    aperture_radius: float = 0.0,
) -> CameraData:
    """Build a CameraData with derived fields filled in (prev == current)."""
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    cam = CameraData(
        pos_w=f32(pos),
        target=f32(target),
        up=f32(up),
        focal_length=f32(focal_length),
        frame_height=f32(frame_height),
        aspect=f32(aspect),
        near_z=f32(near_z),
        far_z=f32(far_z),
        focal_distance=f32(focal_distance),
        aperture_radius=f32(aperture_radius),
        jitter=jnp.zeros(2, jnp.float32),
        camera_u=jnp.zeros(3, jnp.float32),
        camera_v=jnp.zeros(3, jnp.float32),
        camera_w=jnp.zeros(3, jnp.float32),
        view_proj=jnp.eye(4, dtype=jnp.float32),
        prev_view_proj=jnp.eye(4, dtype=jnp.float32),
        inv_view_proj=jnp.eye(4, dtype=jnp.float32),
    )
    cam = derive_camera(cam)
    return cam.replace(prev_view_proj=_unjittered_view_proj(cam))


def _unjittered_view_proj(cam: CameraData):
    fov_y = focal_length_to_fov_y(cam.focal_length, cam.frame_height)
    return _mm(
        perspective(fov_y, cam.aspect, cam.near_z, cam.far_z),
        look_at(cam.pos_w, cam.target, cam.up),
    )


def derive_camera(cam: CameraData) -> CameraData:
    """Recompute U/V/W and matrices from pose + intrinsics (jittable).

    Does NOT roll prev_view_proj — call begin_frame for per-frame updates.
    """
    fov_y = focal_length_to_fov_y(cam.focal_length, cam.frame_height)
    w = normalize(cam.target - cam.pos_w) * cam.focal_distance
    u = normalize(cross(w, cam.up))
    v = normalize(cross(u, w))
    ulen = cam.focal_distance * jnp.tan(fov_y * 0.5) * cam.aspect
    vlen = cam.focal_distance * jnp.tan(fov_y * 0.5)
    vp_nj = _unjittered_view_proj(cam)
    # Jitter matrix adds 2*jitter to clip x/y (Camera.cpp:101-106).
    jitter_mat = jnp.eye(4, dtype=jnp.float32)
    jitter_mat = jitter_mat.at[0, 3].set(2.0 * cam.jitter[0])
    jitter_mat = jitter_mat.at[1, 3].set(2.0 * cam.jitter[1])
    vp = _mm(jitter_mat, vp_nj)
    return cam.replace(
        camera_u=u * ulen,
        camera_v=v * vlen,
        camera_w=w,
        view_proj=vp,
        inv_view_proj=jnp.linalg.inv(vp),
    )


def begin_frame(cam: CameraData, jitter=None) -> CameraData:
    """Per-frame camera update: roll prevViewProj <- unjittered current, set
    new jitter, re-derive (Camera::beginFrame semantics, Camera.cpp:55-62)."""
    prev = _unjittered_view_proj(cam)
    if jitter is not None:
        cam = cam.replace(jitter=jnp.asarray(jitter, jnp.float32))
    cam = derive_camera(cam)
    return cam.replace(prev_view_proj=prev)


def camera_ray_dirs(cam: CameraData, width: int, height: int, pixel_jitter,
                    row0=0, sub_height: int | None = None):
    """Primary ray directions through each pixel, Falcor ray-gen convention
    (lightProbeGBuffer.rt.hlsl:122-125):
      pixelCenter = (index + jitter) / dim;  ndc = (2,-2)*pixelCenter + (-1,1)
      dir = ndc.x*U + ndc.y*V + W, divided by |W| (NOT normalized).
    Returns [H,W,3] un-normalized dirs (normalize for tracing; keep raw for
    thin-lens focal point math).

    row0/sub_height restrict output to rows [row0, row0+sub_height) of the
    full image — the shard_map row-sharded path (parallel.sharding); row0
    may be a traced scalar (lax.axis_index).
    """
    sub_h = height if sub_height is None else sub_height
    xs = (jnp.arange(width, dtype=jnp.float32) + pixel_jitter[0]) / width
    ys = (jnp.arange(sub_h, dtype=jnp.float32)
          + jnp.asarray(row0, jnp.float32) + pixel_jitter[1]) / height
    ndc_x = 2.0 * xs - 1.0
    ndc_y = -2.0 * ys + 1.0
    d = (
        ndc_x[None, :, None] * cam.camera_u[None, None, :]
        + ndc_y[:, None, None] * cam.camera_v[None, None, :]
        + cam.camera_w[None, None, :]
    )
    return d / jnp.linalg.norm(cam.camera_w)


def project_dir_to_pixel(cam: CameraData, d, dims, jitter):
    """World direction -> pixel id, for light-tracing splats.

    Matches getLaunchIndexFromDirection (BDPTUtils.hlsli:129-138): project
    onto the U/V/W basis, perspective divide by the W component, then
    round(pixelCenter*dim - jitter).  Returns (ix, iy) int32 (unclamped; the
    caller masks out-of-range ids).
    """
    d1 = _vdot(d, cam.camera_u) / _vdot3(cam.camera_u)
    d2 = _vdot(d, cam.camera_v) / _vdot3(cam.camera_v)
    d3 = _vdot(d, cam.camera_w) / _vdot3(cam.camera_w)
    ndc_x = d1 / d3
    ndc_y = -d2 / d3
    px = (ndc_x * 0.5 + 0.5) * dims[0] - jitter[0]
    py = (ndc_y * 0.5 + 0.5) * dims[1] - jitter[1]
    return (
        jnp.round(px).astype(jnp.int32),
        jnp.round(py).astype(jnp.int32),
    )


def _vdot(a, b):
    return a[..., 0] * b[0] + a[..., 1] * b[1] + a[..., 2] * b[2]


def _vdot3(v):
    return v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
