"""Render configuration (the analogue of the reference's three config tiers:
compile-time defines, SampleConfig/ArgList CLI, and per-pass GUI variables —
SURVEY.md §5).  All fields here are *static* under jit: changing one
recompiles, which replaces the reference's shader-define toggles
(RayLaunch::addDefine) and refresh-flag machinery."""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class BDPTConfig:
    """BDPTPass GUI/CB parameters (BDPTPass.h:32-40, BDPTPass.cpp:79-94)."""

    max_depth: int = 3            # mUserSpecifiedRayDepth (GUI 0..8)
    max_possible_depth: int = 8   # mMaxPossibleRayDepth (path arrays 9)
    mat_model: int = 0            # gMatIndex: 0 GGX, 1 Lambertian
    clamp_upper: float = 0.9      # mClampUpper
    refractive_index: float = 1.0  # gRefractiveIndex (dielectric hook)
    emit_mult: float = 1.0        # gEmitMult
    min_t: float = 1.0e-3         # ResourceManager shared mMinT
    # --- fidelity switches (ours) ---
    # faithful_rng: reproduce the reference's by-value seed in sampleBRDF
    # (MaterialUtils.hlsli:130): subpath bounces re-draw the same randoms.
    faithful_rng: bool = False
    # reference_quirks: keep (a) the stale path vertex recorded at a miss
    # bounce (globalIlluminationRay.hlsli:14-19 leaves payload geometry from
    # the previous hit), (b) getUnweightedContribution's aL index bug
    # (BDPTUtils.hlsli:198 uses cameraIndex for the light path).
    reference_quirks: bool = True
    # connection weighting: 'uniform' = shipped 1/pathLength
    # (BDPTMain.rt.hlsl:164,197,228); 'power'/'balance' = corrected MIS from
    # the dead getWeightPower/getWeightLinear code (BDPTUtils.hlsli:226-278).
    connection_weight: str = "uniform"
    # estimator family toggles (ours; the reference always runs all three)
    enable_path_tracing: bool = True    # estimator 1 (NEE path tracing)
    enable_light_tracing: bool = True   # estimator 2 (camera splats)
    enable_connections: bool = True     # estimator 3 (s,t connections)
    # Trace est-1/est-2 shadow rays REVERSED — from the light point / camera
    # toward the surface vertex instead of the reference's vertex-outward
    # orientation (BDPTMain.rt.hlsl:118-120, 191-196).  Any-hit visibility
    # over an open segment is orientation-symmetric (no backface culling on
    # shadow rays), and the reversed wavefront shares ONE origin per lane
    # population (the camera; each light).  Off by default; equivalence-
    # tested (tests/test_features.py::
    # test_reverse_shadows_matches_reference_orientation).
    # Differences vs the reference orientation are pure FP rounding at
    # grazing hits (same open interval (min_t, dist) tested from the other
    # end); est-3 connection rays keep their orientation either way.
    reverse_shadows: bool = False
    # Trace the camera and light subpath extension wavefronts TOGETHER:
    # per bounce depth, the camera-ext and light-ext rays merge into ONE
    # 2x-wavefront (5 closest traces -> 3).  DEVIATION: the reference threads
    # ONE sequential RNG through camera-then-light subpaths per pixel
    # (BDPTMain.rt.hlsl:73-145); merging the traces requires the light
    # subpath to draw from an INDEPENDENT stream (TEA-seeded with a
    # salted frame id), so per-sample noise differs from the reference's
    # while every estimator expectation is unchanged (statistically
    # identical Monte Carlo; tests/test_features.py pins converged-mean
    # agreement).  Default OFF: bit-comparable sequences are the parity
    # baseline (PARITY.md).  Its speed on the GPU is not measured.
    parallel_subpaths: bool = False
    # Fire ALL estimator visibility queries (est-1 NEE + est-3 connections
    # + est-2 camera splats) as ONE any-hit batch instead of three
    # per-family batches.  Output-identical (visibility rays are
    # independent; same rays, same intervals).  Only applies with
    # reverse_shadows=False (the reversed orientations change per-family
    # origins).  Its speed on the GPU is not measured.
    merge_shadow_batches: bool = False
    # --- timing-attribution stubs (NEVER for rendering; both break the
    # image).  debug_stub_shadows short-circuits every estimator visibility
    # query to "visible"; debug_stub_extensions skips the subpath extension
    # traces (XLA then dead-code-eliminates them).  Frame differencing with
    # these isolates any-hit cost / extension-trace cost from estimator
    # math inside ONE jitted frame, where XLA cannot elide work the way it
    # can in a standalone micro-benchmark.
    debug_stub_shadows: bool = False
    debug_stub_extensions: bool = False


@dataclass(frozen=True)
class GBufferConfig:
    """LightProbeGBufferPass parameters (LightProbeGBufferPass.h:53-70)."""

    use_thin_lens: bool = False
    f_stop: float = 32.0
    focal_length_gui: float = 1.0  # thin-lens focal length (GUI units)
    jitter_mode: str = "msaa8"     # 'msaa8' | 'random' | 'none'
    # env-map miss filtering: False = nearest texel (reference parity,
    # lightProbeGBuffer.rt.hlsl:64-74), True = bilinear (quality option)
    env_bilinear: bool = False


@dataclass(frozen=True)
class AccumulateConfig:
    """SimpleAccumulationPass (SimpleAccumulationPass.h:70-71)."""

    max_accum_count: int = 100


@dataclass(frozen=True)
class BMFRConfig:
    """DenoisePass toggles + constants (DenoisePass.h:71-75, regressionCP
    defines, preprocess/postprocess alphas)."""

    # master switch; the reference ships with mDoDenoise = false
    # (DenoisePass.h:70) and the GUI enables it
    enabled: bool = False
    preprocess: bool = True
    regression: bool = False
    postprocess: bool = True
    remove_ld_features: bool = True   # IGNORE_LD_fEATURES define
    half_screen_debug: bool = True    # denoise left half only (preprocess:38)
    block_edge: int = 32
    noise_amount: float = 0.01
    position_limit_sq: float = 0.01
    normal_limit_sq: float = 1.0
    blend_alpha: float = 0.2
    second_blend_alpha: float = 0.1
    # regression linear solver:
    # 'qr'     — the reference's Householder QR transliteration
    #            (regressionCP.hlsl:207-466), including its per-column
    #            rank-deficiency skip / add-noise variants;
    # 'normal' — mathematically identical normal-equations form: one
    #            batched Gram matmul [B,13,13] + a 10-step Cholesky whose
    #            pivot value sqrt(G[c,c] - sum L^2) EQUALS the QR's reduced
    #            column norm (same >0.01 accept rule, same R, same
    #            back-substitution) — ~3 passes over the [B,1024,13]
    #            feature tensor instead of ~20 (the QR's per-reflection
    #            read-modify-writes).  Differences are f32 rounding only
    #            (normal equations square the conditioning, but features
    #            are min/max-normalized to [0,1] first).
    # Both are exact-parity tested (tests/test_bmfr.py).  Default 'normal':
    # on an H100 (700 W) its BMFR pass took 1.65 ms against 2.42 ms for
    # 'qr' in a profiled Cornell 1280x720 frame (PERF.md).
    regression_solver: str = "normal"
    # history fetch packing for the reprojection taps (pre+postprocess):
    # 'f32'  — exact: [pos3|norm3|noisy4] (40 packed cols, 3 gathers) in
    #          preprocess + [filtered3] (12 cols, 1 gather) in postprocess;
    # 'bf16' — ONE combined 13-value/tap history table packed as bf16x2
    #          pairs (28 i32 cols -> 2 gathers sharing one index vector),
    #          half the fetched bytes.  Deviation: history
    #          pos/norm/colors quantized to bf16 (<= 2^-8 relative; the
    #          accept thresholds are 0.1 position / 1.0 normal distances,
    #          and spp <= 256 is bf16-EXACT while both blend-alpha floors
    #          make spp > 10 behaviorally irrelevant).  The reference keeps
    #          f32 history textures (DenoisePass.cpp:26-37).  Sharded mode
    #          packs the 13-col history BEFORE the halo exchange, halving
    #          its bytes as well (passes/bmfr.bmfr_pass).  Requires
    #          preprocess+postprocess both on (the combined fetch shares
    #          one index vector); otherwise f32.
    history_pack: str = "f32"
    # multi-chip only: rows of prev-frame history exchanged across shard
    # boundaries for the reprojection taps (no reference equivalent — the
    # reference is single-GPU).  Taps reprojecting further than this are
    # rejected like off-screen taps; exact vs single-chip while inter-frame
    # motion stays within the margin.
    shard_history_margin: int = 64


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    bdpt: BDPTConfig = field(default_factory=BDPTConfig)
    gbuffer: GBufferConfig = field(default_factory=GBufferConfig)
    accumulate: AccumulateConfig = field(default_factory=AccumulateConfig)
    bmfr: BMFRConfig = field(default_factory=BMFRConfig)
    tone_map_operator: str = "clamp"

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
