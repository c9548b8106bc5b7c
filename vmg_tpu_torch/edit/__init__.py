"""The mmedit-equivalent stack of ``vmg_tpu/edit``: so far its training
hooks (:mod:`vmg_tpu_torch.edit.hooks`)."""
