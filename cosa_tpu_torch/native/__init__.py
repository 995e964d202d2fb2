from cosa_tpu_torch.native.build import load_native  # noqa: F401
