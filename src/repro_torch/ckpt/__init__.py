from repro_torch.ckpt.checkpoint import latest_step, restore, save, step_path  # noqa: F401
