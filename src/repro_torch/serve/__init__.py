from repro_torch.serve.engine import Engine, Request  # noqa: F401
