from tfimm_tpu_torch.utils.convert import state_dict_from_jax  # noqa: F401
