from repro_torch.optim.optim import (AdamState, SgdState, adam_init,  # noqa: F401
                                     adam_update, clip_by_global_norm,
                                     cosine_schedule, sgd_init, sgd_update)
