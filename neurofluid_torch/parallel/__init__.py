"""Multi-rank execution over `torch.distributed` (port of
neurofluid_tpu/parallel): the mesh of process groups (`mesh`), the
collectives as autograd functions (`collectives`), ray-sharded rendering
and training and particle-sharded transition steps (`sharding`), and the
multi-rank dry run on the CPU (`dryrun`).

The package imports nothing here: the sharded ParticleNet imports
`parallel.collectives`, and `parallel.sharding` imports the models."""
