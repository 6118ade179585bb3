"""BMFR denoiser — Blockwise Multi-Order Feature Regression.

Rebuild of the reference's 3-stage DenoisePass
(Passes/DenoisePass.cpp:148-279):

  1. preprocess  (preprocess.ps.hlsl): temporal reprojection through
     prevViewProj, 2x2 bilinear tap acceptance by world-position (<0.01) and
     normal (<1.0) distance, exponential blend alpha = max(1/(spp+1), 0.2),
     spp carried in alpha.
  2. regression  (regressionCP.hlsl): per 32x32 block, 13-column feature
     matrix [1, n, p, p^2, rgb/albedo], min/max feature normalization,
     Householder QR + back-substitution for 3 color channels.  Two variants
     like the reference: IGNORE_LD_fEATURES (rank-deficient column skipping,
     the default) and add-noise regularization.  The reference runs one
     256-thread group per block with groupshared reductions; here every block
     is one batch element of dense [B, 1024, 13] math, with no
     shared-memory choreography.
  3. postprocess (postprocess.ps.hlsl): second temporal accumulation of the
     filtered frame, alpha = max(1/spp, 0.1).

The reference denoises only the left half of the screen for A/B comparison
(texC.x > 0.5 early-outs, preprocess:38/postprocess:25, and the halved
horizontal block count, DenoisePass.cpp:262-268); `half_screen_debug`
reproduces that.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import pytree
from ..utils.config import BMFRConfig

BLOCK_EDGE = 32
BLOCK_PIXELS = 1024
FEATURES = 10
BUFFERS = 13
FEATURES_NOT_SCALED = 4

# regressionCP.hlsl:40-58
BLOCK_OFFSETS = jnp.asarray(
    [
        [-30, -30], [-12, -22], [-24, -2], [-8, -16], [-26, -24], [-14, -4],
        [-4, -28], [-26, -16], [-4, -2], [-24, -32], [-10, -10], [-18, -18],
        [-12, -30], [-32, -4], [-2, -20], [-22, -12],
    ],
    dtype=jnp.int32,
)


@pytree.dataclass
class BMFRState:
    """History textures (DenoisePass.h mInputTex) + accumulation counter."""

    prev_pos: jnp.ndarray       # [H,W,4]
    prev_norm: jnp.ndarray      # [H,W,4]
    prev_noisy: jnp.ndarray     # [H,W,4]
    prev_filtered: jnp.ndarray  # [H,W,4]
    frame_number: jnp.ndarray   # [] int32 (mAccumCount)

    @classmethod
    def create(cls, height: int, width: int):
        z = jnp.zeros((height, width, 4), jnp.float32)
        return cls(prev_pos=z, prev_norm=z, prev_noisy=z, prev_filtered=z,
                   frame_number=jnp.zeros((), jnp.int32))


def _mirror(idx, size):
    """mirror addressing (regressionCP.hlsl:60-68)."""
    idx = jnp.where(idx < 0, jnp.abs(idx) - 1, idx)
    idx = jnp.where(idx >= size, 2 * size - idx - 1, idx)
    return idx


def _pack_2x2(img):
    """[H,W,C] -> [H+1,W+1,4C] 2x2-neighborhood pack.

    Entry [g_y, g_x] holds img[g-1+o] (edge-clamped) for the four bilinear
    offsets o in {(0,0),(1,0),(0,1),(1,1)}; gathering at g = base+1 fetches
    all four taps of a bilinear footprint in ONE gather with exact behavior
    for base = -1 edge cases.
    """
    padded = jnp.pad(img, ((1, 0), (1, 0), (0, 0)), mode="edge")
    right = jnp.concatenate([padded[:, 1:], padded[:, -1:]], axis=1)
    down = jnp.concatenate([padded[1:], padded[-1:]], axis=0)
    down_right = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    return jnp.concatenate([padded, right, down, down_right], axis=-1)


def _gather_2x2(pack, base, h, w, y0=0):
    """Fetch the 4-tap block for integer base coords ([H,W,2] int32).
    `y0` is the global row of the pack's first image row (sharded history
    windows); `h` is the pack's image-row count.  The wide pack is fetched
    as several <=16-column gathers sharing one index vector."""
    gx = jnp.clip(base[..., 0] + 1, 0, w)
    gy = jnp.clip(base[..., 1] - y0 + 1, 0, h)
    c = pack.shape[-1]
    flat = pack.reshape(-1, c)
    idx = gy * (w + 1) + gx
    parts = [flat[:, s:min(s + 16, c)][idx] for s in range(0, c, 16)]
    return jnp.concatenate(parts, axis=-1)


def _extend_rows(x, n_top, n_bot, axis_name, n_shards, full_h, mode):
    """Row-halo exchange for shard_map row sharding.

    `x` is this shard's [sub_h, W, C] block of a full [full_h, W, C] image.
    Returns the [n_top + sub_h + n_bot, W, C] window of global rows
    [r0 - n_top, r1 + n_bot), where rows outside the image are
    symmetric-reflected (mode='symmetric', matching jnp.pad) or zero
    (mode='zero').

    When each halo fits in one neighbour (n <= sub_h) this is one
    `ppermute` per direction; otherwise (tiny shards, e.g. the
    driver dry run) it falls back to an `all_gather` + dynamic slice.
    """
    sub_h = x.shape[0]
    idx = jax.lax.axis_index(axis_name)
    if 0 < n_top <= sub_h and 0 < n_bot <= sub_h:
        top_recv = jax.lax.ppermute(
            x[-n_top:], axis_name, [(i, i + 1) for i in range(n_shards - 1)]
        )
        bot_recv = jax.lax.ppermute(
            x[:n_bot], axis_name, [(i, i - 1) for i in range(1, n_shards)]
        )
        if mode == "symmetric":
            top_edge = x[:n_top][::-1]
            bot_edge = x[-n_bot:][::-1]
        else:
            top_edge = jnp.zeros_like(top_recv)
            bot_edge = jnp.zeros_like(bot_recv)
        top = jnp.where(idx == 0, top_edge, top_recv)
        bot = jnp.where(idx == n_shards - 1, bot_edge, bot_recv)
        return jnp.concatenate([top, x, bot], axis=0)
    if mode == "symmetric" and max(n_top, n_bot) > full_h:
        raise ValueError(
            f"sharded BMFR needs image height >= halo ({max(n_top, n_bot)})"
        )
    full = jax.lax.all_gather(x, axis_name, axis=0, tiled=True)
    pad_mode = "symmetric" if mode == "symmetric" else "constant"
    padded = jnp.pad(full, ((n_top, n_bot), (0, 0), (0, 0)), mode=pad_mode)
    r0 = idx * sub_h
    return jax.lax.dynamic_slice(
        padded, (r0, 0, 0), (n_top + sub_h + n_bot,) + tuple(x.shape[1:])
    )


def _pack2bf16(x, y):
    """Two f32 -> one i32 carrying (bf16(x) << 16) | bf16(y)."""
    xb = jax.lax.bitcast_convert_type(x.astype(jnp.bfloat16), jnp.uint16)
    yb = jax.lax.bitcast_convert_type(y.astype(jnp.bfloat16), jnp.uint16)
    return (
        (xb.astype(jnp.uint32) << 16) | yb.astype(jnp.uint32)
    ).astype(jnp.int32)


def _unpack2bf16(p):
    u = p.astype(jnp.uint32)
    x = jax.lax.bitcast_convert_type(
        (u >> 16).astype(jnp.uint16), jnp.bfloat16).astype(jnp.float32)
    y = jax.lax.bitcast_convert_type(
        (u & jnp.uint32(0xFFFF)).astype(jnp.uint16),
        jnp.bfloat16).astype(jnp.float32)
    return x, y


def _pack_hist_bf16(hist13):
    """[H,W,13] f32 history [pos3|norm3|noisy_rgb3|spp|filtered3] -> [H,W,7]
    i32 of bf16x2 pairs (see BMFRConfig.history_pack).  Pair layout:
    (px,py)(pz,nx)(ny,nz)(nr,ng)(nb,spp)(fr,fg)(fb,0)."""
    pairs = []
    order = list(range(13)) + [None]  # pad to 14 = 7 pairs
    for k in range(7):
        a = hist13[..., order[2 * k]]
        bidx = order[2 * k + 1]
        b = jnp.zeros_like(a) if bidx is None else hist13[..., bidx]
        pairs.append(_pack2bf16(a, b))
    return jnp.stack(pairs, -1)


def _unpack_hist_bf16(taps_i):
    """[H,W,28] i32 (4 taps x 7 pairs) -> (taps [H,W,40] in the f32 layout
    [pos3|norm3|noisy_rgb3|spp] per tap, filt_taps [H,W,12])."""
    taps_cols = []
    filt_cols = []
    for t in range(4):
        p = taps_i[..., 7 * t:7 * (t + 1)]
        vals = []
        for k in range(7):
            a, b = _unpack2bf16(p[..., k])
            vals.extend([a, b])
        taps_cols.extend(vals[:10])      # pos3 norm3 rgb3 spp
        filt_cols.extend(vals[10:13])    # filtered rgb
    return jnp.stack(taps_cols, -1), jnp.stack(filt_cols, -1)


def _hash_random(a):
    """random() (regressionCP.hlsl:78-87): integer hash -> [0,1) float."""
    a = a.astype(jnp.uint32)
    a = (a + jnp.uint32(0x7ED55D16)) + (a << 12)
    a = (a ^ jnp.uint32(0xC761C23C)) ^ (a >> 19)
    a = (a + jnp.uint32(0x165667B1)) + (a << 5)
    a = (a + jnp.uint32(0xD3A2646C)) ^ (a << 9)
    a = (a + jnp.uint32(0xFD7046C5)) + (a << 3)
    a = (a ^ jnp.uint32(0xB55A4F09)) ^ (a >> 16)
    return a.astype(jnp.float32) / jnp.float32(4294967296.0)


# ------------------------------------------------------------- preprocess
def preprocess(state: BMFRState, cur_pos, cur_norm, cur_noisy, prev_view_proj,
               cfg: BMFRConfig, *, hist=None, hist_y0=0, full_h=None,
               pack: str = "f32"):
    """Temporal reprojection + first blend (preprocess.ps.hlsl).

    Returns (blended_noisy [H,W,4] with spp in alpha, accept_bits [H,W] int32,
    prev_pixel_f [H,W,2], filt_taps) where filt_taps is the postprocess's
    [H,W,12] prev_filtered tap block when pack='bf16' fetched it alongside
    (one shared index vector), else None.

    Sharded use: `hist` is a pre-assembled [Hh, W, 10] history window
    ([prev_pos3 | prev_norm3 | prev_noisy4]) whose row 0 is GLOBAL row
    `hist_y0`, and `full_h` is the global image height; taps landing outside
    the window are rejected like off-screen taps.  Defaults reproduce the
    single-chip behavior exactly (hist = whole history, hist_y0 = 0).
    """
    h, w = cur_noisy.shape[0], cur_noisy.shape[1]
    if full_h is None:
        full_h = h
    wp = cur_pos[..., :3]
    nrm = cur_norm[..., :3]
    color = cur_noisy[..., :3]

    # project world pos through prevViewProj (column-vector convention);
    # explicit per-row mads — einsum/dot_general lowers poorly for 4x4xHW
    x, y, z = wp[..., 0], wp[..., 1], wp[..., 2]
    m = prev_view_proj
    cx = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]
    cy_ = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]
    cw = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    inv_w = 1.0 / cw
    uvx = (cx * inv_w + 1.0) * 0.5
    uvy = (1.0 - cy_ * inv_w) * 0.5
    in_screen = (uvx >= 0.0) & (uvx <= 1.0) & (uvy >= 0.0) & (uvy <= 1.0)

    pixel_f = jnp.stack([uvx * w, uvy * full_h], -1) - 0.5  # PIXEL_OFFSET
    base = jnp.floor(pixel_f).astype(jnp.int32)
    frac = pixel_f - jnp.floor(pixel_f)
    omf = 1.0 - frac
    weights = [
        omf[..., 0] * omf[..., 1],
        frac[..., 0] * omf[..., 1],
        omf[..., 0] * frac[..., 1],
        frac[..., 0] * frac[..., 1],
    ]
    offsets = [(0, 0), (1, 0), (0, 1), (1, 1)]

    # packed 2x2-neighborhood history -> ONE gather for all 4 bilinear taps
    filt_taps = None
    if pack == "bf16":
        # combined 13-value/tap fetch incl. the postprocess's prev_filtered
        # taps: 28 i32 cols = 2 gathers instead of pre 3 + post 1.  A
        # pre-PACKED [Hh, W, 7] i32 window (sharded halo exchange ships the
        # bf16 pairs to halve its bytes) is accepted directly.
        if hist is None:
            hist = jnp.concatenate(
                [state.prev_pos[..., :3], state.prev_norm[..., :3],
                 state.prev_noisy, state.prev_filtered[..., :3]], axis=-1,
            )
        hist_h = hist.shape[0]
        packed7 = hist if hist.dtype == jnp.int32 else _pack_hist_bf16(hist)
        history = _pack_2x2(packed7)  # [Hh+1, W+1, 28] i32
        taps_i = _gather_2x2(history, base, hist_h, w, y0=hist_y0)
        taps, filt_taps = _unpack_hist_bf16(taps_i)
    else:
        if hist is None:
            hist = jnp.concatenate(
                [state.prev_pos[..., :3], state.prev_norm[..., :3],
                 state.prev_noisy], axis=-1,
            )
        hist_h = hist.shape[0]
        history = _pack_2x2(hist)  # [Hh+1, W+1, 40]
        taps = _gather_2x2(history, base, hist_h, w, y0=hist_y0)  # [H, W, 40]

    prev_color = jnp.zeros_like(color)
    sample_spp = jnp.zeros((h, w), jnp.float32)
    total_weight = jnp.zeros((h, w), jnp.float32)
    accept = jnp.zeros((h, w), jnp.int32)
    for i, (dx, dy) in enumerate(offsets):
        sx = base[..., 0] + dx
        sy = base[..., 1] + dy
        valid = (
            (sx >= 0) & (sx < w)
            & (sy >= 0) & (sy < full_h)
            & (sy >= hist_y0) & (sy < hist_y0 + hist_h)
        )
        tap = taps[..., 10 * i:10 * (i + 1)]
        pos_ok = jnp.sum((tap[..., 0:3] - wp) ** 2, -1) < cfg.position_limit_sq
        nrm_ok = jnp.sum((tap[..., 3:6] - nrm) ** 2, -1) < cfg.normal_limit_sq
        ok = valid & pos_ok & nrm_ok
        accept = accept | jnp.where(ok, 1 << i, 0)
        wgt = jnp.where(ok, weights[i], 0.0)
        prev_color = prev_color + wgt[..., None] * tap[..., 6:9]
        sample_spp = sample_spp + wgt * tap[..., 9]
        total_weight = total_weight + wgt

    has_prev = total_weight > 0.0
    prev_color = jnp.where(
        has_prev[..., None], prev_color / jnp.maximum(total_weight, 1e-20)[..., None], 0.0
    )
    sample_spp = jnp.where(has_prev, sample_spp / jnp.maximum(total_weight, 1e-20), 0.0)
    blend_alpha = jnp.where(
        has_prev, jnp.maximum(1.0 / (sample_spp + 1.0), cfg.blend_alpha), 1.0
    )

    first_frame = state.frame_number <= 0
    blend_alpha = jnp.where(first_frame | ~in_screen, 1.0, blend_alpha)
    accept = jnp.where(first_frame | ~in_screen, 0, accept)

    new_spp = jnp.where(blend_alpha < 1.0, 1.0 + sample_spp, 1.0)
    new_color = blend_alpha[..., None] * color + (1.0 - blend_alpha[..., None]) * prev_color
    out = jnp.concatenate([new_color, new_spp[..., None]], -1)

    if cfg.half_screen_debug:
        # texC.x > 0.5 early-out (preprocess.ps.hlsl:38); accept/prev-pixel
        # stay stale in the reference but are only read for the left half.
        xs = jnp.arange(w)[None, :, None]
        right = xs >= ((w + 1) // 2)
        out = jnp.where(right, cur_noisy, out)
    return out, accept, pixel_f, filt_taps


# ------------------------------------------------------------- regression
_PAD_L = BLOCK_EDGE           # covers BLOCK_OFFSETS in [-32, -2]
_PAD_R = 2 * BLOCK_EDGE       # covers n_blocks*32 + off - size <= 61


def _features_from_window(win, n_blocks_y: int, n_blocks_x: int):
    """Build the [B, 1024, 13] feature tensor from a block-aligned window.

    The reference's per-thread fetch (regressionCP.hlsl:104-124) is pixel
    (block*32 + local + BLOCK_OFFSETS[frame%16]) with mirror addressing —
    a REGULAR grid: the whole tensor is one shifted window of the
    symmetric-padded image.  A pad + dynamic_slice + block reshape replaces
    a 1M-index gather with slices that are pure bandwidth.  `win` is that [n_by*32, n_bx*32, 12] window."""
    b = n_blocks_x * n_blocks_y
    row = (
        win.reshape(n_blocks_y, BLOCK_EDGE, n_blocks_x, BLOCK_EDGE, 12)
        .transpose(0, 2, 1, 3, 4)
        .reshape(b, BLOCK_PIXELS, 12)
    )
    p = row[..., 0:3]
    n = row[..., 3:6]
    alb = row[..., 6:9]
    c = row[..., 9:12]
    c_over_a = jnp.where(alb < 0.01, 0.0, c / jnp.maximum(alb, 1e-20))

    ones = jnp.ones((b, BLOCK_PIXELS), jnp.float32)
    feats = jnp.stack(
        [
            ones,
            n[..., 0], n[..., 1], n[..., 2],
            p[..., 0], p[..., 1], p[..., 2],
            p[..., 0] ** 2, p[..., 1] ** 2, p[..., 2] ** 2,
            c_over_a[..., 0], c_over_a[..., 1], c_over_a[..., 2],
        ],
        axis=-1,
    )  # [B, 1024, 13]
    return feats, alb


def _fit_window(win, n_blocks_y: int, n_blocks_x: int, frame_number,
                cfg: BMFRConfig):
    """Feature build + QR fit over one window; returns the fitted rgb image
    with the window's spatial shape (regressionCP.hlsl `fit` body)."""
    feats, alb = _features_from_window(win, n_blocks_y, n_blocks_x)
    x = _normalize_features(feats)
    solver = cfg.regression_solver
    if cfg.remove_ld_features:
        wts = (_householder_qr_skip_ld(x) if solver == "qr"
               else _normal_eq_skip_ld(x))
    elif solver == "qr":
        wts = _householder_qr_noise(x, frame_number, cfg.noise_amount)
    else:
        wts = _normal_eq_noise(x, frame_number, cfg.noise_amount)
    fitted = jnp.einsum(
        "bpf,bfc->bpc", x[..., :FEATURES], wts,
        precision=jax.lax.Precision.HIGHEST,
    )  # [B, 1024, 3]
    fitted = jnp.maximum(fitted, 0.0)
    out_rgb = alb * fitted  # alb from the same block taps
    return (
        out_rgb.reshape(n_blocks_y, n_blocks_x, BLOCK_EDGE, BLOCK_EDGE, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(n_blocks_y * BLOCK_EDGE, n_blocks_x * BLOCK_EDGE, 3)
    )


def _normalize_features(x):
    """Min/max normalize scaled features (regressionCP.hlsl:127-190)."""
    cols = []
    for f in range(BUFFERS):
        col = x[..., f]
        if FEATURES_NOT_SCALED <= f < FEATURES:
            cmin = jnp.min(col, axis=1, keepdims=True)
            cmax = jnp.max(col, axis=1, keepdims=True)
            span = cmax - cmin
            col = jnp.where(span > 1.0, (col - cmin) / jnp.where(span > 1.0, span, 1.0),
                            col - cmin)
        cols.append(col)
    return jnp.stack(cols, axis=-1)


def _householder_qr_noise(a, frame_number, noise_amount):
    """The add_random variant (regressionCP.hlsl:346-466 path).

    a: [B, 1024, 13].  Returns weights [B, 10, 3].
    """
    b = a.shape[0]
    rows = jnp.arange(BLOCK_PIXELS)

    # noise is added to feature columns 1..9 during the col==0 reflection,
    # identical across blocks (the hash ignores the group id).
    pid = rows[:, None]
    fid = jnp.arange(BUFFERS)[None, :]
    noise_idx = pid + fid * BLOCK_PIXELS + frame_number * BUFFERS * BLOCK_PIXELS
    noise = noise_amount * 2.0 * (_hash_random(noise_idx) - 0.5)
    noise = jnp.where((fid >= 1) & (fid < FEATURES), noise, 0.0)
    a = a + noise[None, :, :]

    rmat = jnp.zeros((b, FEATURES, BUFFERS), jnp.float32)
    for col in range(FEATURES):
        u = a[:, :, col]                              # [B, 1024]
        mask_hi = rows > col                          # strictly below diagonal
        norm_sq = jnp.sum(jnp.where(mask_hi[None, :], u * u, 0.0), axis=1)
        u_col = u[:, col]
        vec_len = jnp.sqrt(norm_sq + u_col * u_col)
        u_new_col = u_col - vec_len
        u_len_sq = norm_sq + u_new_col * u_new_col
        uvec = jnp.where((rows == col)[None, :], u_new_col[:, None], u)
        uvec = jnp.where((rows < col)[None, :], 0.0, uvec)
        # R entries for this column: rows<col keep current values; row col = |v|
        r_col = jnp.where((jnp.arange(FEATURES) < col)[None, :],
                          a[:, :FEATURES, col],
                          jnp.where((jnp.arange(FEATURES) == col)[None, :],
                                    vec_len[:, None], 0.0))
        rmat = rmat.at[:, :, col].set(r_col)
        # reflect remaining columns
        dots = jnp.einsum("bp,bpc->bc", uvec, a, precision=jax.lax.Precision.HIGHEST)
        scale = 2.0 / jnp.maximum(u_len_sq, 1e-30)
        update = uvec[:, :, None] * (dots * scale[:, None])[:, None, :]
        # only columns > col are reflected; finished columns live in rmat
        keep = (jnp.arange(BUFFERS) <= col)[None, None, :]
        a = jnp.where(keep, a, a - update)
    # Q^T y rows 0..9 live in the transformed color columns
    qty = a[:, :FEATURES, FEATURES:BUFFERS]
    # back substitution
    weights = jnp.zeros((b, FEATURES, 3), jnp.float32)
    wrows = qty
    for i in range(FEATURES - 1, -1, -1):
        diag = rmat[:, i, i]
        wi = wrows[:, i, :] / diag[:, None]
        weights = weights.at[:, i, :].set(wi)
        if i > 0:
            above = rmat[:, :i, i]
            wrows = wrows.at[:, :i, :].add(-above[:, :, None] * wi[:, None, :])
    return weights


def _householder_qr_skip_ld(a):
    """The IGNORE_LD_fEATURES variant (regressionCP.hlsl:207-344): columns
    whose remaining norm is <= 0.01 are zeroed in R and skipped; the pivot
    row advances only on accepted columns.  Returns weights [B, 10, 3]
    (zeros for skipped columns)."""
    b = a.shape[0]
    rows = jnp.arange(BLOCK_PIXELS)
    rmat = jnp.zeros((b, FEATURES, BUFFERS), jnp.float32)
    limit = jnp.zeros((b,), jnp.int32)

    for col in range(FEATURES):
        u = a[:, :, col]
        mask_hi = rows[None, :] > limit[:, None]
        norm_sq = jnp.sum(jnp.where(mask_hi, u * u, 0.0), axis=1)
        # one-hot reduction instead of take_along_axis: a masked select
        # fuses into the surrounding reduction
        u_piv = jnp.sum(
            jnp.where(rows[None, :] == limit[:, None], u, 0.0), axis=1
        )
        vec_len = jnp.sqrt(norm_sq + u_piv * u_piv)
        accept = vec_len > 0.01
        u_new_piv = u_piv - vec_len
        u_len_sq = norm_sq + u_new_piv * u_new_piv
        do_reflect = accept & (u_len_sq >= 0.001)

        uvec = jnp.where(rows[None, :] == limit[:, None], u_new_piv[:, None], u)
        uvec = jnp.where(rows[None, :] < limit[:, None], 0.0, uvec)

        # R column: rows < limit copy the (already reduced) column values,
        # row == limit gets |v|, rest zero; rejected columns are all-zero.
        ridx = jnp.arange(FEATURES)
        r_col = jnp.where(ridx[None, :] < limit[:, None], a[:, :FEATURES, col], 0.0)
        r_col = jnp.where(ridx[None, :] == limit[:, None], vec_len[:, None], r_col)
        r_col = jnp.where(accept[:, None], r_col, 0.0)
        rmat = rmat.at[:, :, col].set(r_col)

        dots = jnp.einsum("bp,bpc->bc", uvec, a, precision=jax.lax.Precision.HIGHEST)
        scale = jnp.where(do_reflect, 2.0 / jnp.maximum(u_len_sq, 1e-30), 0.0)
        update = uvec[:, :, None] * (dots * scale[:, None])[:, None, :]
        keep = (jnp.arange(BUFFERS) <= col)[None, None, :]
        a = jnp.where(keep, a, a - update)
        limit = limit + accept.astype(jnp.int32)

    qty = a[:, :FEATURES, FEATURES:BUFFERS]

    # LD back substitution (regressionCP.hlsl:323-344): walk columns 9..0,
    # consuming pivot rows from `limit-1` downward for accepted columns.
    weights = jnp.zeros((b, FEATURES, 3), jnp.float32)
    wrows = qty  # [B, 10, 3] running right-hand sides
    limit = limit - 1
    ridx = jnp.arange(FEATURES)
    for i in range(FEATURES - 1, -1, -1):
        onehot = (ridx[None, :] == limit[:, None])[..., None]
        piv_r = jnp.sum(jnp.where(onehot, rmat, 0.0), axis=1)  # [B, 13]
        diag = piv_r[:, i]
        accepted = (diag != 0.0) & (limit >= 0)
        piv_rhs = jnp.sum(jnp.where(onehot, wrows, 0.0), axis=1)  # [B, 3]
        wi = jnp.where(accepted[:, None], piv_rhs / jnp.where(accepted[:, None], diag[:, None], 1.0), 0.0)
        weights = weights.at[:, i, :].set(wi)
        new_limit = limit - accepted.astype(jnp.int32)
        # subtract from remaining rows 0..new_limit: wrows[r] -= R[r, i] * wi
        row_mask = (ridx[None, :] <= new_limit[:, None]) & accepted[:, None]
        coeff = jnp.where(row_mask, rmat[:, :, i], 0.0)
        wrows = wrows - coeff[:, :, None] * wi[:, None, :]
        limit = new_limit
    return weights


def _qr_noise_pattern(frame_number, noise_amount):
    """The add_random noise image (regressionCP.hlsl:89-98), identical
    across blocks, applied to feature columns 1..9."""
    rows = jnp.arange(BLOCK_PIXELS)
    pid = rows[:, None]
    fid = jnp.arange(BUFFERS)[None, :]
    noise_idx = pid + fid * BLOCK_PIXELS + frame_number * BUFFERS * BLOCK_PIXELS
    noise = noise_amount * 2.0 * (_hash_random(noise_idx) - 0.5)
    return jnp.where((fid >= 1) & (fid < FEATURES), noise, 0.0)


def _normal_eq_factor(a, skip_ld: bool):
    """Cholesky factor of the Gram matrix with the reference's per-column
    skip rule — the normal-equations form of the Householder QR
    (BMFRConfig.regression_solver='normal').

    In exact arithmetic the pivot value sqrt(G[c,c] - sum_k R[k,c]^2) IS
    the QR's reduced column norm `vec_len` (the norm of column c's residual
    against the span of the accepted previous columns), so the accept
    threshold (> 0.01, regressionCP.hlsl:255) and the resulting R — with
    the transformed color columns riding along as rmat[:, :, 10:13] = Q^T y
    rows — match the QR transliteration; the only differences are f32
    rounding.  One batched matmul reads `a` once instead of ten
    reflection read-modify-write passes.

    Returns (rmat [B, 10, 13], limit [B]) like the QR builds."""
    b = a.shape[0]
    g = jnp.einsum("bpi,bpj->bij", a, a,
                   precision=jax.lax.Precision.HIGHEST)   # [B, 13, 13]
    rmat = jnp.zeros((b, FEATURES, BUFFERS), jnp.float32)
    limit = jnp.zeros((b,), jnp.int32)
    ridx = jnp.arange(FEATURES)
    jidx = jnp.arange(BUFFERS)
    accepts = []
    for col in range(FEATURES):
        cross = jnp.einsum("bk,bkj->bj", rmat[:, :, col], rmat,
                           precision=jax.lax.Precision.HIGHEST)  # [B, 13]
        d2 = g[:, col, col] - cross[:, col]
        vec_len = jnp.sqrt(jnp.maximum(d2, 0.0))
        if skip_ld:
            accept = vec_len > 0.01
        else:
            accept = jnp.ones((b,), bool)
        accepts.append(accept)
        row = (g[:, col, :] - cross) / jnp.maximum(vec_len, 1e-30)[:, None]
        row = jnp.where((jidx >= col)[None, :] & accept[:, None], row, 0.0)
        onehot = (ridx[None, :] == limit[:, None]).astype(jnp.float32)
        rmat = rmat + onehot[:, :, None] * row[:, None, :]
        limit = limit + accept.astype(jnp.int32)
    # a rejected column's R entries are ZERO in the QR (its r_col is zeroed
    # on reject, regressionCP.hlsl:255-263); the factor wrote its
    # projections onto earlier pivots while it was still a candidate, so
    # blank rejected columns wholesale — the back-substitution keys its
    # accept decisions off diag != 0.
    col_ok = jnp.concatenate(
        [jnp.stack(accepts, -1), jnp.ones((b, BUFFERS - FEATURES), bool)],
        axis=-1,
    )
    rmat = jnp.where(col_ok[:, None, :], rmat, 0.0)
    return rmat, limit


def _normal_eq_skip_ld(a):
    """IGNORE_LD_fEATURES weights via the normal-equations factor; the
    back-substitution is the QR version's, verbatim semantics."""
    rmat, limit = _normal_eq_factor(a, skip_ld=True)
    qty = rmat[:, :, FEATURES:BUFFERS]
    b = a.shape[0]
    weights = jnp.zeros((b, FEATURES, 3), jnp.float32)
    wrows = qty
    limit = limit - 1
    ridx = jnp.arange(FEATURES)
    for i in range(FEATURES - 1, -1, -1):
        onehot = (ridx[None, :] == limit[:, None])[..., None]
        piv_r = jnp.sum(jnp.where(onehot, rmat, 0.0), axis=1)
        diag = piv_r[:, i]
        accepted = (diag != 0.0) & (limit >= 0)
        piv_rhs = jnp.sum(jnp.where(onehot, wrows, 0.0), axis=1)
        wi = jnp.where(accepted[:, None],
                       piv_rhs / jnp.where(accepted[:, None], diag[:, None],
                                           1.0), 0.0)
        weights = weights.at[:, i, :].set(wi)
        new_limit = limit - accepted.astype(jnp.int32)
        row_mask = (ridx[None, :] <= new_limit[:, None]) & accepted[:, None]
        coeff = jnp.where(row_mask, rmat[:, :, i], 0.0)
        wrows = wrows - coeff[:, :, None] * wi[:, None, :]
        limit = new_limit
    return weights


def _normal_eq_noise(a, frame_number, noise_amount):
    """add_random-variant weights via the normal-equations factor (noise
    applied to `a` first, exactly like _householder_qr_noise)."""
    a = a + _qr_noise_pattern(frame_number, noise_amount)[None, :, :]
    rmat, _ = _normal_eq_factor(a, skip_ld=False)
    qty = rmat[:, :, FEATURES:BUFFERS]
    b = a.shape[0]
    weights = jnp.zeros((b, FEATURES, 3), jnp.float32)
    wrows = qty
    for i in range(FEATURES - 1, -1, -1):
        diag = rmat[:, i, i]
        wi = wrows[:, i, :] / diag[:, None]
        weights = weights.at[:, i, :].set(wi)
        if i > 0:
            above = rmat[:, :i, i]
            wrows = wrows.at[:, :i, :].add(-above[:, :, None] * wi[:, None, :])
    return weights


def regression(cur_pos, cur_norm, albedo, noisy, frame_number, cfg: BMFRConfig):
    """Fit + replace noisy color per block (regressionCP.hlsl `fit`)."""
    h, w = noisy.shape[0], noisy.shape[1]
    n_blocks_x = (w + BLOCK_EDGE - 1) // BLOCK_EDGE + 1
    if cfg.half_screen_debug:
        n_blocks_x //= 2  # DenoisePass.cpp:266-268 halves horizontal coverage
    n_blocks_y = (h + BLOCK_EDGE - 1) // BLOCK_EDGE + 1
    off = BLOCK_OFFSETS[frame_number % 16]

    tab = jnp.concatenate(
        [cur_pos[..., :3], cur_norm[..., :3], albedo[..., :3],
         noisy[..., :3]], -1,
    )  # [H, W, 12]
    padded = jnp.pad(
        tab, ((_PAD_L, _PAD_R), (_PAD_L, _PAD_R), (0, 0)), mode="symmetric"
    )
    win = jax.lax.dynamic_slice(
        padded, (_PAD_L + off[1], _PAD_L + off[0], 0),
        (n_blocks_y * BLOCK_EDGE, n_blocks_x * BLOCK_EDGE, 12),
    )
    fitted_img = _fit_window(win, n_blocks_y, n_blocks_x, frame_number, cfg)

    # write-back is the inverse regular-grid window: un-block, place into a
    # padded canvas at the frame offset, slice the live region (the old
    # scatter-set — blocks are disjoint in shifted space, so this is exact)
    canvas = jnp.pad(
        noisy[..., :3], ((_PAD_L, _PAD_R), (_PAD_L, _PAD_R), (0, 0))
    )
    canvas = jax.lax.dynamic_update_slice(
        canvas, fitted_img, (_PAD_L + off[1], _PAD_L + off[0], 0)
    )
    new_rgb = canvas[_PAD_L:_PAD_L + h, _PAD_L:_PAD_L + w]
    return jnp.concatenate([new_rgb, noisy[..., 3:4]], -1)


def regression_sharded(cur_pos, cur_norm, albedo, noisy, frame_number,
                       cfg: BMFRConfig, axis_name: str, n_shards: int,
                       full_h: int):
    """`regression` under shard_map row sharding — matches the single-chip
    output within 1e-5 (tests/test_parallel.py::test_bmfr_sharded_matches_single;
    the recomputed boundary blocks see identical halo data, but XLA may fuse
    and order the per-shard QR arithmetic differently, so equality is
    tolerance-level, not bitwise).

    Each shard computes exactly the 32x32 blocks that intersect its owned
    rows; blocks straddling a shard boundary are recomputed by both
    neighbours from identical halo data, and each shard writes back only
    its own rows.  Halo: 32 rows
    above + (32*n_loc - sub_h) <= 63 rows below, one ppermute each
    (reference block grid: regressionCP.hlsl:28-58,
    DenoisePass.cpp:262-268)."""
    sub_h, w = noisy.shape[0], noisy.shape[1]
    n_blocks_x = (w + BLOCK_EDGE - 1) // BLOCK_EDGE + 1
    if cfg.half_screen_debug:
        n_blocks_x //= 2
    # blocks that can intersect [row0, row0+sub_h) for any frame offset
    n_loc = (sub_h - 1) // BLOCK_EDGE + 2
    n_bot = BLOCK_EDGE * n_loc - sub_h  # in [32, 63]

    idx = jax.lax.axis_index(axis_name)
    row0 = idx.astype(jnp.int32) * sub_h
    tab = jnp.concatenate(
        [cur_pos[..., :3], cur_norm[..., :3], albedo[..., :3],
         noisy[..., :3]], -1,
    )  # [sub_h, W, 12]
    ext = _extend_rows(tab, BLOCK_EDGE, n_bot, axis_name, n_shards, full_h,
                       "symmetric")
    ext = jnp.pad(ext, ((0, 0), (_PAD_L, _PAD_R), (0, 0)), mode="symmetric")

    off = BLOCK_OFFSETS[frame_number % 16]
    k_min = (row0 - off[1]) // BLOCK_EDGE     # first block touching row0
    g0 = off[1] + BLOCK_EDGE * k_min          # its global start row <= row0
    s = g0 - row0 + BLOCK_EDGE                # start row in ext, in (0, 32]
    win = jax.lax.dynamic_slice(
        ext, (s, _PAD_L + off[0], 0),
        (BLOCK_EDGE * n_loc, n_blocks_x * BLOCK_EDGE, 12),
    )
    fitted_img = _fit_window(win, n_loc, n_blocks_x, frame_number, cfg)

    canvas = jnp.pad(
        noisy[..., :3], ((BLOCK_EDGE, n_bot), (_PAD_L, _PAD_R), (0, 0))
    )
    canvas = jax.lax.dynamic_update_slice(
        canvas, fitted_img, (s, _PAD_L + off[0], 0)
    )
    new_rgb = canvas[BLOCK_EDGE:BLOCK_EDGE + sub_h, _PAD_L:_PAD_L + w]
    return jnp.concatenate([new_rgb, noisy[..., 3:4]], -1)


# ------------------------------------------------------------ postprocess
def postprocess(state: BMFRState, filtered, accept, prev_pixel_f, cfg: BMFRConfig,
                *, hist=None, hist_y0=0, taps=None):
    """Second temporal accumulation (postprocess.ps.hlsl).

    `taps` short-circuits the prev_filtered fetch with a pre-gathered
    [H,W,12] tap block (the bf16 combined fetch in preprocess).

    Sharded use: `hist` is the [Hh, W, 3] prev_filtered window with global
    row `hist_y0` first, assembled with the SAME margin as preprocess so the
    accept bits guarantee every accepted tap lies inside the window."""
    h, w = filtered.shape[0], filtered.shape[1]
    color = filtered[..., :3]
    spp = filtered[..., 3]

    base = jnp.floor(prev_pixel_f).astype(jnp.int32)
    frac = prev_pixel_f - jnp.floor(prev_pixel_f)
    omf = 1.0 - frac
    weights = [
        omf[..., 0] * omf[..., 1],
        frac[..., 0] * omf[..., 1],
        omf[..., 0] * frac[..., 1],
        frac[..., 0] * frac[..., 1],
    ]
    offsets = [(0, 0), (1, 0), (0, 1), (1, 1)]
    if taps is None:
        if hist is None:
            hist = state.prev_filtered[..., :3]
        pack = _pack_2x2(hist)
        taps = _gather_2x2(pack, base, hist.shape[0], w, y0=hist_y0)  # [H,W,12]
    prev_color = jnp.zeros_like(color)
    total_weight = jnp.zeros((h, w), jnp.float32)
    for i, _ in enumerate(offsets):
        bit_ok = (accept & (1 << i)) != 0
        wgt = jnp.where(bit_ok, weights[i], 0.0)
        prev_color = prev_color + wgt[..., None] * taps[..., 3 * i:3 * (i + 1)]
        total_weight = total_weight + wgt

    has_prev = (total_weight > 0.0) & (accept > 0) & (state.frame_number > 0)
    blend_alpha = jnp.where(
        has_prev, jnp.maximum(1.0 / jnp.maximum(spp, 1e-20), cfg.second_blend_alpha), 1.0
    )
    prev_color = jnp.where(
        has_prev[..., None], prev_color / jnp.maximum(total_weight, 1e-20)[..., None], 0.0
    )
    out_rgb = blend_alpha[..., None] * color + (1.0 - blend_alpha[..., None]) * prev_color
    out = jnp.concatenate([out_rgb, jnp.ones((h, w, 1), jnp.float32)], -1)
    if cfg.half_screen_debug:
        xs = jnp.arange(w)[None, :, None]
        out = jnp.where(xs >= ((w + 1) // 2), filtered, out)
    return out


# ------------------------------------------------------------- full pass
def bmfr_pass(state: BMFRState, channels: dict, camera, cfg: BMFRConfig,
              *, axis_name: str | None = None, n_shards: int = 1,
              full_h: int | None = None):
    """Full denoise stage over the channel dict; returns (state, output).

    Follows DenoisePass::execute ordering exactly: preprocess -> history
    blits (noisy/norm/pos) -> regression -> postprocess -> blit accumulated
    into the output + filtered history.

    Sharded mode (axis_name set, inside shard_map row sharding): history
    and current channels are this shard's rows; reprojection taps come from
    a +-`cfg.shard_history_margin`-row halo window exchanged between shards (taps
    reprojecting further than the margin are rejected like off-screen taps
    — exact vs single-chip whenever inter-frame motion stays within the
    margin), and regression runs per shard with exact 32-row block halos.
    """
    cur_pos = channels["WorldPosition"]
    cur_norm = channels["WorldNormal"]
    albedo = channels["MaterialDiffuse"]
    noisy = channels["Accumulated"]

    # mDoDenoise master gate (DenoisePass.cpp:158): disabled -> plain blit
    if not cfg.enabled or not (cfg.preprocess or cfg.regression or cfg.postprocess):
        return state, noisy

    sharded = axis_name is not None and n_shards > 1
    sub_h = noisy.shape[0]
    if full_h is None:
        full_h = sub_h
    margin = min(cfg.shard_history_margin, full_h)
    if sharded:
        row0 = jax.lax.axis_index(axis_name).astype(jnp.int32) * sub_h
        hist_y0 = row0 - margin
    else:
        hist_y0 = 0

    accept = jnp.zeros(noisy.shape[:2], jnp.int32)
    xs = jnp.arange(noisy.shape[1], dtype=jnp.float32)[None, :]
    ys = jnp.arange(noisy.shape[0], dtype=jnp.float32)[:, None]
    prev_pixel_f = jnp.stack(jnp.broadcast_arrays(xs, ys), -1)

    pack = cfg.history_pack
    if not (cfg.preprocess and cfg.postprocess):
        # the combined fetch needs both stages' taps on one index vector
        pack = "f32"

    filt_taps = None
    if cfg.preprocess:
        hist = None
        if sharded and pack == "bf16":
            # sharded bf16: pack the 13-col history into bf16x2 pairs
            # BEFORE the halo exchange — the same combined fetch as
            # single-chip, at half the bytes (7 i32 vs 13 f32 cols)
            hist = _extend_rows(
                _pack_hist_bf16(jnp.concatenate(
                    [state.prev_pos[..., :3], state.prev_norm[..., :3],
                     state.prev_noisy, state.prev_filtered[..., :3]], -1,
                )),
                margin, margin, axis_name, n_shards, full_h, "zero",
            )
        elif sharded:
            hist = _extend_rows(
                jnp.concatenate(
                    [state.prev_pos[..., :3], state.prev_norm[..., :3],
                     state.prev_noisy], -1,
                ),
                margin, margin, axis_name, n_shards, full_h, "zero",
            )
        noisy, accept, prev_pixel_f, filt_taps = preprocess(
            state, cur_pos, cur_norm, noisy, camera.prev_view_proj, cfg,
            hist=hist, hist_y0=hist_y0, full_h=full_h, pack=pack,
        )

    # history blits (DenoisePass.cpp:180-182)
    state = state.replace(prev_noisy=noisy, prev_norm=cur_norm, prev_pos=cur_pos)

    if cfg.regression:
        if sharded:
            noisy = regression_sharded(
                cur_pos, cur_norm, albedo, noisy, state.frame_number, cfg,
                axis_name, n_shards, full_h,
            )
        else:
            noisy = regression(
                cur_pos, cur_norm, albedo, noisy, state.frame_number, cfg
            )

    if cfg.postprocess:
        hist_f = None
        if sharded and filt_taps is None:
            # bf16 mode already fetched the filtered taps in preprocess
            hist_f = _extend_rows(
                state.prev_filtered[..., :3],
                margin, margin, axis_name, n_shards, full_h, "zero",
            )
        accumulated = postprocess(
            state, noisy, accept, prev_pixel_f, cfg,
            hist=hist_f, hist_y0=hist_y0, taps=filt_taps,
        )
        out = accumulated
        state = state.replace(prev_filtered=accumulated)
    else:
        out = noisy

    state = state.replace(frame_number=state.frame_number + 1)
    return state, out
