"""Command-line entry points of the port, run as
`python -m neurofluid_torch.cli.<name>` with the root scripts' flags
(`--expdir`, `--expname`, `--dataset`, `--config`, `--dataset_config`,
`--resume_from`): train_renderer, train_transmodel, train_e2e, eval_e2e,
eval_transmodel and eval_renderer. They run on the card. The host tools
beside them: convert_particles, evaluate_images (its LPIPS on the card
unless `--device cpu`), generate_data and import_torch_ckpt. The
reference-protocol run: full_protocol_run (its budget in the `PROTO_*`
environment variables) and reval_e2e_rollout."""
