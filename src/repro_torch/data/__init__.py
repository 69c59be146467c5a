from repro_torch.data.pipeline import SyntheticLMData, markov_batch  # noqa: F401
