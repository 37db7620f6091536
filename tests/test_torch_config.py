"""Config parity: the port's ``config.load_config`` against the JAX
package's on every YAML the repository ships, field for field."""

import dataclasses
from pathlib import Path

import pytest

from super_primitive_tpu.config import load_config as jload_config
from super_primitive_tpu_torch.config import load_config as tload_config

REPO = Path(__file__).resolve().parents[1]
SHIPPED = (["config/replica_sfm_example.yaml"]
           + sorted(str(p.relative_to(REPO)) for p in (REPO / "config" / "tum").glob("*.yaml"))
           + ["config/depth_completion/void_dataset.yaml"])


def test_every_shipped_config_is_listed():
    assert len(SHIPPED) == 11
    assert sorted(SHIPPED) == sorted(str(p.relative_to(REPO))
                                     for p in (REPO / "config").rglob("*.yaml"))


@pytest.mark.parametrize("path", SHIPPED)
def test_config_equals_jax(path):
    got = dataclasses.asdict(tload_config(str(REPO / path)))
    want = dataclasses.asdict(jload_config(str(REPO / path)))
    assert got == want
