"""Test configuration: the suite runs on a virtual 8-device CPU mesh.

JAX_PLATFORMS defaults to "cpu" here; a caller that sets it (for example
`JAX_PLATFORMS=cuda,cpu` to run the `gpu`-marked card checks) keeps its
choice.  XLA_FLAGS gets the 8-virtual-device override before jax
initializes a backend.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from fyp_bidirectionalpathtracer_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

jax.config.update("jax_enable_x64", False)

# The suite's wall time is dominated by XLA compiles; persist them so reruns
# finish in minutes instead of tens of minutes.
enable_compile_cache()
