"""Test harness configuration.

Defaults to the CPU backend with 8 virtual devices BEFORE any computation so
multi-device sharding tests run anywhere (SURVEY.md 4: multi-host tests via
mesh simulation). ``JAX_PLATFORMS`` is only defaulted, never overridden: the
tests marked ``gpu`` run on the card with ``JAX_PLATFORMS=cuda`` (README,
"Tests"), and decide inside a fixture whether a card is there.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Small device batches so pipeline tests exercise multi-batch carry chaining.
os.environ.setdefault("BLT_DEVICE_BATCH_BYTES", str(256 * 1024))
