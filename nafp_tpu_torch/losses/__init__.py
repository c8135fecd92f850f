from nafp_tpu_torch.losses.ntxent import ntxent_loss  # noqa: F401
from nafp_tpu_torch.losses.triplet import online_triplet_loss  # noqa: F401
