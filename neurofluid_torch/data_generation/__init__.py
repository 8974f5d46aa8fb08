"""Offline ground-truth data generation: SPlisHSPlasH scene runner, classic
bgeo particle I/O (partio replacement), and surface meshing (host-side
numpy; a copy of neurofluid_tpu/data_generation over the port's
`data.synthetic`)."""

from neurofluid_torch.data_generation import bgeo, physics_scenes, surface_meshes  # noqa: F401
