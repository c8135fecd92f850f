from nafp_tpu_torch.losses.ntxent import ntxent_loss  # noqa: F401
