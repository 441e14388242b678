import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
# are exercised without a GPU. Must be set before jax import.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# make f64 *available* for physics-validation tests (compute dtype is still
# chosen explicitly per test; production default stays f32)
jax.config.update("jax_enable_x64", True)

import pytest


@pytest.fixture(scope="session")
def waterbox_dir(tmp_path_factory):
    """The reference's examples/waterbox deck layout, generated in the
    repository (models.martini_water(waterbox=True))."""
    from ddcmd_tpu.models import martini_water

    d = tmp_path_factory.mktemp("waterbox")
    martini_water(str(d), waterbox=True)
    return d
