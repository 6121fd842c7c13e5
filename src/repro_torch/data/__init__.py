from repro_torch.data.synthetic import ZeroShotEvalDataset  # noqa: F401
