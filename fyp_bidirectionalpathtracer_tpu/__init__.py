"""Bidirectional path tracer (BDPT) + BMFR denoiser framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
DirectX-Raytracing bidirectional path tracer (SunBangjie/FYP-BidirectionalPathTracer):
ray-traced G-buffer, BDPT with three estimator families, temporal accumulation,
and Blockwise Multi-Order Feature Regression denoising — built as a wavefront
renderer over ray SoA buffers instead of a per-pixel DXR megakernel.

Layer map (analogue of the reference's Falcor stack):
  core/      — vec math, counter/LCG RNG, samplers        (BDPTUtils/BRDFUtils math)
  scene/     — cameras, lights, materials, .fscene loader (Falcor Graphics/Scene)
  models/    — mesh import + procedural scene builders    (Falcor Graphics/Model)
  accel/     — BVH build (host, C++/numpy) + traversal    (DXR TLAS/BLAS + TraceRay)
  ops/       — BRDF/material/shading/texture/tonemap jnp  (ShadingUtils + HLSL includes)
  passes/    — G-buffer, BDPT, accumulation, BMFR, extras (CommonPasses + BDPT app)
  pipeline/  — pass harness, channel registry, driver     (SharedUtils RenderingPipeline)
  parallel/  — jax.sharding mesh helpers, row-sharded rendering (no reference equivalent)
  utils/     — profiler, logging, config, image IO        (Falcor Utils)
"""

__version__ = "0.1.0"
