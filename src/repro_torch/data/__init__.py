from repro_torch.data.pipeline import SyntheticLMData  # noqa: F401
