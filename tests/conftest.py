"""Test configuration: virtual 8-device CPU mesh + float64.

Multi-chip sharding is validated on a fake-device CPU mesh
(xla_force_host_platform_device_count) — the accelerator-world analog of a
fake backend (SURVEY.md section 4).  float64 is enabled so spectral/assembly
oracles can be checked to tight tolerances; library code still runs in its
configured dtype (explicit casts throughout).
"""

import os

flag = "--xla_force_host_platform_device_count=8"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + flag).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
