from repro_torch.optim.optim import AdamState, adam_init, adam_update
