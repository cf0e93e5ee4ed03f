from repro_torch.optim.optimizers import adagrad, adam, make_optimizer  # noqa: F401
