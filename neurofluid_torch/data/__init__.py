"""Data pipeline: Blender multi-view scenes, windowed particle sequences,
particle and point-cloud I/O, and a synthetic scene generator (host-side
numpy; port of neurofluid_tpu/data)."""

from neurofluid_torch.data import io, synthetic  # noqa: F401
from neurofluid_torch.data.blender import BlenderDataset  # noqa: F401
from neurofluid_torch.data.particles import ParticleDataset  # noqa: F401
