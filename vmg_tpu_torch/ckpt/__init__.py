"""Checkpoints: the reference's ``.pth`` files in, the port's own trainer
state out and back."""

from vmg_tpu_torch.ckpt.io import (latest_step, load_trainer_state, restore_checkpoint,
                                   save_checkpoint, trainer_state)
from vmg_tpu_torch.ckpt.torch_convert import (convert_spynet_state_dict, convert_torch_state_dict,
                                              export_torch_state_dict,
                                              load_reference_checkpoint,
                                              normalize_torch_checkpoint, reference_state_dict,
                                              remap_ttvsr_pretrain, save_reference_checkpoint,
                                              strip_module_prefix, verify_against)
