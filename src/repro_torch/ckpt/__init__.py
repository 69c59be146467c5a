from repro_torch.ckpt.checkpoint import latest_step, restore, save  # noqa: F401
